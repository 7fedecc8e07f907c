"""The vmap-vs-scan drift (ROADMAP Queue 3), separated: both packages'
vmap and scan rounds on the same inputs and the reference's draws, and the
f32 ReLU kink that amplifies the two modes' last-bit difference.

Run as a script, it prints, for each of ``--rounds`` round counts, both
packages' largest |vmap − scan| and how many params differ (full-width
VGG-9 by default, a few minutes on the CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_drift.py \\
        [--reduced] [--num-train 2000] [--rounds 3] [--seed 0]
"""
import argparse
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from test_torch_engine import (JaxDraws, jscan, max_diff,  # noqa: E402
                               to_torch, tscan)
import repro.data as jdata  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.core.units import tree_cast  # noqa: E402
from repro_torch.data import ClientShards  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402


def mode_drift(reduced: bool, num_train: int, rounds: int, seed: int = 0):
    """Both packages' engines at the paper's FL setup (fedldf, N=50, K=20,
    n=4, B=32) in vmap and scan mode from the same initial weights, with
    the reference's draws: per package, the largest |vmap − scan| of the
    params after each round count 1..``rounds`` and how many elements
    differ, and the port's distance to the reference in each mode."""
    from repro.configs import vgg9_cifar10 as jvgg9
    from repro_torch.configs import vgg9_cifar10 as tvgg9
    jcfg, tcfg = jvgg9.config(), tvgg9.config()
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jtrain, _ = jdata.make_image_dataset(num_train=num_train, num_test=16,
                                         seed=seed)
    ttrain, _ = tdata.make_image_dataset(num_train=num_train, num_test=16,
                                         seed=seed)
    jd = jdata.FederatedData(jtrain.xs, jtrain.ys,
                             jdata.iid_partition(jtrain.ys, 50, seed=seed))
    td = tdata.FederatedData(ttrain.xs, ttrain.ys,
                             tdata.iid_partition(ttrain.ys, 50, seed=seed))
    jp = jcnn.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = to_torch(jp)

    def jloss(p, b):
        return jcnn.classify_loss(p, jcfg, b)

    def tloss(p, b):
        return tcnn.classify_loss(p, tcfg, b)

    out = {"reference": [], "port": [], "reference_elements": [],
           "port_elements": [], "port_vs_reference_vmap": [],
           "port_vs_reference_scan": []}

    def differing(a, b):
        return int(sum((np.asarray(x) != np.asarray(y)).sum() for x, y in
                       zip(jax.tree.leaves(a), jax.tree.leaves(b))))

    for r in range(1, rounds + 1):
        j, t = {}, {}
        for mode in ("vmap", "scan"):
            j[mode], _ = jscan(jp, jloss, jd, dataclasses.replace(
                jvgg9.fl_config(), mode=mode), rounds=r, seed=seed)
            t[mode], _ = tscan(tp, tloss, td, tvgg9.fl_config(mode=mode),
                               rounds=r, seed=seed, device="cpu",
                               draws=JaxDraws(seed))
            out[f"port_vs_reference_{mode}"].append(max_diff(t[mode],
                                                             j[mode]))
        out["reference"].append(max_diff(to_torch(j["vmap"]), j["scan"]))
        out["port"].append(max_diff(t["vmap"], params_to_numpy(t["scan"])))
        out["reference_elements"].append(differing(j["vmap"], j["scan"]))
        out["port_elements"].append(differing(params_to_numpy(t["vmap"]),
                                              params_to_numpy(t["scan"])))
    return out


def test_vmap_scan_drift_is_an_f32_relu_kink():
    """ROADMAP Queue 3, the vmap-vs-scan drift: at the paper's FL setup on
    the reduced VGG-9 (2,000 images, seed 4, the reference's draws) the
    two modes' params differ by ~1e-7 after round 1. In round 2, client
    0 has conv3 pre-activations 3.1e-8 from the ReLU kink, and their f32
    gates differ between the two states: that client's f32 gradients
    then differ by ~1e-3, while the same gradients in float64 differ by
    ~1e-7. The drift is the kink amplifying an f32 rounding difference,
    not a fault of either mode."""
    from repro_torch.configs import vgg9_cifar10 as tvgg9
    tcfg = tcnn.VGGConfig().reduced()
    train, _ = tdata.make_image_dataset(num_train=2000, num_test=16, seed=4)
    data = tdata.FederatedData(train.xs, train.ys,
                               tdata.iid_partition(train.ys, 50, seed=4))
    tp = to_torch(jcnn.init_params(jax.random.PRNGKey(4),
                                   jcnn.VGGConfig().reduced()))

    def loss(p, b):
        return tcnn.classify_loss(p, tcfg, b)

    draws = JaxDraws(4)
    states = [tscan(tp, loss, data, tvgg9.fl_config(mode=mode), rounds=1,
                    seed=4, device="cpu", draws=draws)[0]
              for mode in ("vmap", "scan")]
    assert 0 < max_diff(states[0], params_to_numpy(states[1])) <= 2.4e-7
    rd = draws(1)
    shards = ClientShards.from_federated(data)
    clients = rd.clients(50, 20)
    batch = shards.gather(clients, rd.indices(shards.part_sizes[clients],
                                              32))
    b0 = {k: v[0] for k, v in batch.items()}

    def grad_gap(dtype):
        g = [torch.func.grad(loss)(tree_cast(p, dtype),
                                   {"images": b0["images"].to(dtype),
                                    "labels": b0["labels"]})
             for p in states]
        return max_diff(g[0], params_to_numpy(g[1]))

    def conv3_pre(p):
        x = b0["images"]
        for i in range(4):
            q = p[f"conv{i}"]
            x = torch.nn.functional.conv2d(
                x.permute(0, 3, 1, 2), q["w"].permute(3, 2, 0, 1),
                padding=1).permute(0, 2, 3, 1)
            pre = tcnn._batch_norm(x + q["b"], q["scale"], q["bias"])
            x = torch.relu(pre)
            if i in tcfg.pool_after:
                x = torch.nn.functional.max_pool2d(
                    x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return pre

    pa, pb = conv3_pre(states[0]), conv3_pre(states[1])
    flips = (pa > 0) != (pb > 0)
    assert bool(flips.any()) and float(pa[flips].abs().max()) < 1e-7
    assert grad_gap(torch.float32) > 1e-4
    assert grad_gap(torch.float64) < 1e-6


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--num-train", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(json.dumps({"reduced": args.reduced, "num_train": args.num_train,
                      "seed": args.seed,
                      **mode_drift(args.reduced, args.num_train, args.rounds,
                                   args.seed)}))
