"""Writing your own FL algorithm as a strategy plugin, on the PyTorch port
(the port of ``examples/custom_strategy.py``).

    PYTHONPATH=src python examples/custom_strategy_torch.py [--rounds N]
        [--device cpu]

``register_strategy`` is the whole integration surface: subclass
:class:`repro_torch.federated.FLStrategy`, implement the hooks your scheme
needs (here just ``select``; aggregation, comm accounting, the engines,
mesh sharding and quantized uploads are all inherited from the Eq. 5
base), decorate the class, and ``FLConfig(algo=<name>)`` plus every
engine and the ``ALGOS`` listing pick it up. Importing this module
registers two names in the port's registry
(``repro_torch.federated.unregister_strategy`` takes them out).

The demo scheme, "softmax-divergence", is a stochastic softening of the
paper's Eq. 4: instead of deterministically taking the top-n clients per
layer, it samples n clients per layer with probability ∝ softmax of the
divergence scores — same n/K uplink, but cold clients still occasionally
contribute. (This is a demo of the plugin seam, not a claim that it beats
FedLDF.) Its randomness is the round's algorithm stream, ``uniform(shape)
-> f32 in [0, 1)`` on the round's device, which every engine passes to
``select``.

The second scheme, "softmax-div-annealed", demonstrates the cross-round
state seam: declare per-run state once in ``init_state``, read it in
``select_with_state``, advance it in ``update_state``. The drivers thread
the state for you, and ``save_server_state``/``load_server_state``
checkpoint it alongside the params. Here the state is a single round
counter that anneals the sampling temperature from exploration toward the
paper's deterministic Eq. 4. Runs on the card unless ``--device cpu``.
"""
import argparse

import numpy as np
import torch

import repro_torch.federated as fed
from repro_torch.core.selection import topn_divergence
from repro_torch.core.units import tree_leaves
from repro_torch.data import (FederatedData, iid_partition,
                              make_image_dataset)
from repro_torch.federated import (FLConfig, FLStrategy, register_strategy,
                                   run_training_scan)
from repro_torch.models import cnn


@register_strategy("softmax-div")
class SoftmaxDivergence(FLStrategy):
    """Sample n clients per layer ∝ softmax(divergence / temperature)."""

    needs_divergence = True   # the engine feeds us the (K, U) Eq. 3 matrix

    TEMPERATURE = 0.05

    def select(self, divs, uniform, k, u, n, device):
        # Gumbel-top-n per unit = sampling n clients without replacement
        # with probability ∝ softmax(divs / T). Deterministic in the
        # round's stream, so every engine agrees.
        return self._select_at_temperature(divs, uniform, n,
                                           self.TEMPERATURE)

    @staticmethod
    def _select_at_temperature(divs, uniform, n, temperature):
        if uniform is None:
            raise ValueError("softmax-div draws from the round's algorithm "
                             "stream: pass the round function a uniform")
        # uniforms in [1e-9, 1), as jax.random.uniform(minval=1e-9) maps
        # its [0, 1) draws
        lo = 1e-9
        u = torch.clamp(uniform(divs.shape) * (1.0 - lo) + lo, min=lo)
        gumbel = -torch.log(-torch.log(u))
        return topn_divergence(divs / temperature + gumbel, n)


@register_strategy("softmax-div-annealed")
class AnnealedSoftmaxDivergence(SoftmaxDivergence):
    """Stateful variant: a cross-round counter anneals the temperature, so
    early rounds explore (≈ uniform sampling) and late rounds converge on
    the paper's deterministic top-n. The three hooks below are the entire
    stateful surface — every engine threads the state automatically."""

    ANNEAL = 1.5   # temperature multiplier per round (T grows ⇒ sharper)

    def init_state(self, params, num_clients, mesh=None):
        # "global" entries are replicated trees updated wholesale each
        # round; "client" entries (not needed here) carry a leading
        # (num_clients,) axis and get per-participant row gather/scatter
        dev = tree_leaves(params)[0].device
        return {"global": {"round": torch.zeros((), dtype=torch.float32,
                                                device=dev)}}

    def select_with_state(self, state, divs, uniform, k, u, n, device):
        t = state["global"]["round"]
        # sharper softmax every round: T_t = T0 / ANNEAL^t
        temperature = self.TEMPERATURE / torch.pow(self.ANNEAL, t)
        return self._select_at_temperature(divs, uniform, n, temperature)

    def update_state(self, state, selection, divs, umap, uniform=None):
        # shape-preserving transition: runs once per round, after
        # aggregation, in every driver
        return {**state, "global": {"round": state["global"]["round"]
                                    + 1.0}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    print("registered algorithms:", ", ".join(fed.ALGOS))
    assert "softmax-div" in fed.ALGOS

    cfg = cnn.VGGConfig().reduced()
    train, _ = make_image_dataset(num_train=500, num_test=16, seed=0)
    data = FederatedData(train.xs, train.ys,
                         iid_partition(train.ys, 10, seed=0))

    def loss_fn(p, b):
        return cnn.classify_loss(p, cfg, b)

    # the custom name drops straight into FLConfig — validation, the
    # device-resident engine, comm accounting, everything applies
    fl = FLConfig(algo="softmax-div", num_clients=10, clients_per_round=5,
                  top_n=2, lr=0.05, batch_per_client=8)
    params = cnn.init_params(cfg, torch.Generator().manual_seed(0), dev)
    _, log = run_training_scan(params, loss_fn, data, fl,
                               rounds=args.rounds, seed=0, device=dev)
    assert all(np.isfinite(l) for l in log.losses)
    print(f"losses: {[f'{l:.3f}' for l in log.losses]}")
    print(f"uplink {log.meter.uplink_bytes / 1e6:.2f} MB over "
          f"{log.meter.rounds} rounds "
          f"({log.meter.savings_frac * 100:.1f}% saved vs FedAvg)")

    # --- the stateful variant: same engine, plus a cross-round carry ---
    fl2 = FLConfig(algo="softmax-div-annealed", num_clients=10,
                   clients_per_round=5, top_n=2, lr=0.05,
                   batch_per_client=8)
    p0 = cnn.init_params(cfg, torch.Generator().manual_seed(0), dev)
    _, log2 = run_training_scan(p0, loss_fn, data, fl2,
                                rounds=args.rounds, seed=0, device=dev)
    assert all(np.isfinite(l) for l in log2.losses)
    # the engine hands the final strategy state back on the log
    rounds_seen = float(log2.final_state["global"]["round"])
    assert rounds_seen == args.rounds, rounds_seen
    print(f"annealed variant: state counted {rounds_seen:.0f} rounds, "
          f"uplink {log2.meter.uplink_bytes / 1e6:.2f} MB "
          f"({log2.meter.savings_frac * 100:.1f}% saved vs FedAvg)")
    return log, log2


if __name__ == "__main__":
    main()
