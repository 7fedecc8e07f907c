"""The port's trainable-partition seam (``repro_torch.core.partition``,
``FLConfig(partition=...)``) against the reference's: every case of
tests/test_partition.py that runs on one device without telemetry
(split/merge, validation, counts, the FLConfig check, partition=None bit
identity in every driver, frozen invariance and driver agreement, packed
int8 + EF, the LoRA uplink cut), and the partitioned LoRA fine-tuning path
on the tiny dense LM against the reference: 2 rounds of fedldf in vmap and
scan mode and of int8 + error feedback, with the reference's draws
injected (tests/test_torch_engine.py ``JaxDraws``)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from test_torch_engine import (LOSS_TOL, PARAM_TOL, JaxDraws,  # noqa: E402
                               assert_same, max_diff, to_torch)

import repro.data as jdata  # noqa: E402
from repro.core.wire import CompressionConfig as JComp  # noqa: E402
from repro.federated import FLConfig as JFLConfig  # noqa: E402
from repro.federated import run_training_scan as jscan  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.lora import inject_lora as jinject  # noqa: E402
from repro.models.lora import lora_partition as jlora_partition  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.core.partition import (ParamPartition,  # noqa: E402
                                        leaf_paths, partition_counts)
from repro_torch.core.units import tree_leaves  # noqa: E402
from repro_torch.federated import (CompressionConfig, FLConfig,  # noqa: E402
                                   run_training, run_training_scan)
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.lora import inject_lora, lora_partition  # noqa: E402

EQUIV_TOL = 2e-6   # tests/test_partition.py:162


def _mlp_params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "l1": {"w": torch.from_numpy(
                   rng.normal(size=(192, 16)).astype(np.float32) * 0.02),
               "b": torch.zeros(16)},
        "head": {"w": torch.from_numpy(
                     rng.normal(size=(16, 10)).astype(np.float32) * 0.1),
                 "b": torch.zeros(10)},
    }


def _loss(params, batch):
    x = batch["images"].reshape(batch["images"].shape[0], -1)
    h = torch.relu(x @ params["l1"]["w"] + params["l1"]["b"])
    logp = torch.log_softmax(h @ params["head"]["w"] + params["head"]["b"],
                             dim=-1)
    return -torch.take_along_dim(logp, batch["labels"].long()[:, None],
                                 dim=-1).mean()


@pytest.fixture(scope="module")
def fed_data():
    train, _ = tdata.make_image_dataset(num_train=160, num_test=16, size=8,
                                        seed=1)
    parts = tdata.iid_partition(train.ys, 8, seed=0)
    return tdata.FederatedData(train.xs, train.ys, parts)


def _kw(algo="fedldf", top_n=2, **kw):
    return dict(algo=algo, num_clients=8, clients_per_round=4, top_n=top_n,
                batch_per_client=8, **kw)


def _device_run(params, fl, data, **kw):
    return run_training(params, _loss, data, fl, rounds=3, seed=3,
                        sampler="device", device="cpu", **kw)


def _engine_run(params, fl, data, **kw):
    return run_training_scan(params, _loss, data, fl, rounds=3, seed=3,
                             device="cpu", **kw)


# ----------------------------------------------------------------------
# ParamPartition semantics
# ----------------------------------------------------------------------
def test_split_merge_roundtrip():
    params = _mlp_params()
    part = ParamPartition.by_keys(params, ["head"])
    trainable, frozen = part.split(params)
    assert set(trainable) == {"head"} and set(frozen) == {"l1"}
    assert trainable["head"]["w"] is params["head"]["w"]   # no copy
    assert_same(part.merge(trainable, frozen), params)
    # by_substring: path-segment match, not substring-anywhere
    part2 = ParamPartition.by_substring(params, "head")
    assert part2.trainable_paths == part.trainable_paths
    with pytest.raises(ValueError, match="at least one trainable"):
        ParamPartition.by_substring(params, "hea")


def test_partition_validation_errors():
    params = _mlp_params()
    with pytest.raises(KeyError):
        ParamPartition.by_keys(params, ["nope"])
    with pytest.raises(ValueError, match="at least one trainable"):
        ParamPartition.by_substring(params, "nomatch")
    with pytest.raises(ValueError, match="both trainable and frozen"):
        ParamPartition(trainable_paths=("head/w",),
                       frozen_paths=("head/w", "head/b"))
    part = ParamPartition.by_keys(params, ["head"])
    with pytest.raises(ValueError, match="do not match this partition"):
        part.split({**params, "extra": {"w": torch.zeros(2)}})
    with pytest.raises(TypeError):
        ParamPartition.build(torch.zeros(3), lambda p, l: True)


def test_partition_counts_and_paths():
    params = _mlp_params()
    part = ParamPartition.by_keys(params, ["head"])
    c = partition_counts(part, params)
    assert c["trainable_params"] == 16 * 10 + 10
    assert c["frozen_params"] == 192 * 16 + 16
    assert c["trainable_bytes"] == 4 * c["trainable_params"]
    paths = dict(leaf_paths(params))
    assert set(paths) == {"l1/w", "l1/b", "head/w", "head/b"}
    # bytes follow each leaf's own dtype
    half = {"a": torch.zeros(3, dtype=torch.bfloat16), "b": torch.zeros(2)}
    c = partition_counts(ParamPartition.by_keys(half, ["a"]), half)
    assert (c["trainable_bytes"], c["frozen_bytes"]) == (6, 8)


def test_partition_matches_reference_classification():
    """The same paths, counts and hash-equality as the reference's class
    on the same tree."""
    from repro.core.partition import ParamPartition as JPartition
    from repro.core.partition import partition_counts as jcounts
    params = _mlp_params()
    jparams = jax.tree.map(np.asarray, params_to_numpy(params))
    for build in (lambda cls, p: cls.by_keys(p, ["head"]),
                  lambda cls, p: cls.by_substring(p, "l1")):
        got, want = build(ParamPartition, params), build(JPartition, jparams)
        assert got.trainable_paths == want.trainable_paths
        assert got.frozen_paths == want.frozen_paths
        assert partition_counts(got, params) == jcounts(want, jparams)
    assert hash(ParamPartition.by_keys(params, ["head"])) == \
        hash(ParamPartition.by_keys(_mlp_params(1), ["head"]))


def test_flconfig_rejects_non_partition():
    with pytest.raises(TypeError, match="partition"):
        FLConfig(algo="fedldf", clients_per_round=4, partition="head")
    assert FLConfig(remat=True).remat


# ----------------------------------------------------------------------
# partition=None bit identity
# ----------------------------------------------------------------------
@pytest.mark.parametrize("algo", ["fedldf", "fedavg"])
def test_all_trainable_partition_is_bit_identical_to_none(fed_data, algo):
    """partition=None and an all-trainable partition give the same
    trajectory bit for bit in every driver and mode."""
    params = _mlp_params()
    full = ParamPartition.by_keys(params, ["head", "l1"])
    assert full.all_trainable
    for runner in (_device_run, _engine_run):
        p0, l0 = runner(params, FLConfig(**_kw(algo)), fed_data)
        pF, lF = runner(params, FLConfig(partition=full, **_kw(algo)),
                        fed_data)
        assert_same(p0, pF)
        assert l0.losses == lF.losses
    p0, _ = _engine_run(params, FLConfig(mode="scan", **_kw(algo)), fed_data)
    pF, _ = _engine_run(params, FLConfig(mode="scan", partition=full,
                                         **_kw(algo)), fed_data)
    assert_same(p0, pF)


# ----------------------------------------------------------------------
# Partitioned training: frozen invariance + driver equivalence
# ----------------------------------------------------------------------
def test_partitioned_frozen_stays_frozen_and_drivers_agree(fed_data):
    params = _mlp_params()
    part = ParamPartition.by_keys(params, ["head"])
    kw = _kw(top_n=1, partition=part)
    ph, lh = _device_run(params, FLConfig(**kw), fed_data)
    ps, _ = _engine_run(params, FLConfig(**kw), fed_data)
    # frozen leaves untouched (the caller's own tensors); trainable moved
    assert ph["l1"]["w"] is params["l1"]["w"]
    assert_same(ph["l1"], params["l1"])
    assert not torch.equal(ph["head"]["w"], params["head"]["w"])
    assert max_diff(ph, params_to_numpy(ps)) <= EQUIV_TOL
    # sequential-clients engine agrees too
    pq, _ = _engine_run(params, FLConfig(mode="scan", **kw), fed_data)
    assert max_diff(ph, params_to_numpy(pq)) <= EQUIV_TOL
    # the ledger charges trainable bytes only: head = (16·10+10)·4 B
    assert lh.meter.fedavg_uplink_bytes / 3 == 4 * (16 * 10 + 10) * 4


def test_partition_eval_sees_the_merged_model(fed_data):
    params = _mlp_params()
    part = ParamPartition.by_keys(params, ["head"])
    seen = []
    for runner in (_device_run, _engine_run):
        runner(params, FLConfig(**_kw(partition=part)), fed_data,
               eval_fn=lambda p: seen.append(sorted(p)) or 0.5,
               eval_every=2)
    assert seen and all(keys == ["head", "l1"] for keys in seen)


def test_partition_composes_with_packed_compression(fed_data):
    params = _mlp_params()
    part = ParamPartition.by_keys(params, ["head"])
    fl = FLConfig(partition=part, **_kw(
        top_n=1, compression=CompressionConfig(bits=8, error_feedback=True)))
    pc, lc = _device_run(params, fl, fed_data)
    assert_same(pc["l1"], params["l1"])
    # packed int8 uplink of the trainable subset is below its f32 bytes
    assert lc.meter.uplink_bytes < lc.meter.fedavg_uplink_bytes
    # the EF residual store covers the trainable sub-tree only
    res = lc.final_state["client"]["residual"]
    assert set(res) == {"head"} and res["head"]["w"].shape == (8, 16, 10)


# ----------------------------------------------------------------------
# The LoRA fine-tuning path on the tiny dense LM
# ----------------------------------------------------------------------
TINY = dict(name="tiny", family="dense", d_model=64, num_layers=2,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
            param_dtype="float32", compute_dtype="float32")
LM_N, LM_K = 4, 2


@pytest.fixture(scope="module")
def lm_task():
    """(reference params with adapters, port params (the same numbers),
    reference data, port data); the adapters' b is perturbed so that the
    first round already moves every factor."""
    jcfg = JModelConfig(**TINY)
    jparams = jinject(jax.random.PRNGKey(1),
                      jtfm.init_params(jax.random.PRNGKey(0), jcfg), rank=2)
    rng = np.random.default_rng(5)

    def perturb(path, leaf):
        if path[-1].key == "b" and "lora" in jax.tree_util.keystr(path):
            return leaf + 0.05 * rng.normal(size=leaf.shape).astype(
                np.float32)
        return leaf
    jparams = jax.tree_util.tree_map_with_path(perturb, jparams)
    tokens, domains = jdata.make_lm_dataset(num_sequences=64, seq_len=17,
                                            vocab=128, num_domains=4, seed=0)
    return (jparams, to_torch(jparams),
            jdata.lm_federated(tokens, domains, LM_N),
            tdata.lm_federated(tokens, domains, LM_N))


def _lm_fl(cls, comp_cls=None, partition=None, **kw):
    if comp_cls is not None:
        kw["compression"] = comp_cls(bits=8, error_feedback=True)
    return cls(algo="fedldf", num_clients=LM_N, clients_per_round=LM_K,
               top_n=1, batch_per_client=4, partition=partition, **kw)


def _lm_runs(lm_task, mode="vmap", compressed=False, seed=0):
    jp, tp, jd, td = lm_task
    jfl = _lm_fl(JFLConfig, JComp if compressed else None,
                 jlora_partition(jp), mode=mode)
    tfl = _lm_fl(FLConfig, CompressionConfig if compressed else None,
                 lora_partition(tp), mode=mode)
    jparams, jlog = jscan(jp, jtfm.make_lm_loss(JModelConfig(**TINY)), jd,
                          jfl, rounds=2, seed=seed)
    tparams, tlog = run_training_scan(
        tp, tfm.make_lm_loss(ModelConfig(**TINY)), td, tfl, rounds=2,
        seed=seed, device="cpu", draws=JaxDraws(seed))
    return tp, tparams, tlog, jax.tree.map(np.asarray, jparams), jlog


def _assert_frozen_identical(part, start, trained):
    _, f0 = part.split(start)
    _, f1 = part.split(trained)
    for a, b in zip(tree_leaves(f0), tree_leaves(f1)):
        assert a is b


@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_lora_fedldf_matches_reference(lm_task, mode):
    tp, tparams, tlog, jparams, jlog = _lm_runs(lm_task, mode)
    np.testing.assert_allclose(tlog.losses, jlog.losses, atol=LOSS_TOL,
                               rtol=0)
    assert max_diff(tparams, jparams) <= PARAM_TOL
    assert tlog.meter.uplink_bytes == pytest.approx(jlog.meter.uplink_bytes)
    _assert_frozen_identical(lora_partition(tp), tp, tparams)
    assert max_diff(tparams, params_to_numpy(tp)) > 0.0   # adapters moved


def test_lora_int8_ef_matches_reference(lm_task):
    """int8 levels + error feedback over the adapters. A last-bit
    difference in the locals can move an element on a .5 boundary to the
    next int8 level, so each adapter leaf may differ by one quantization
    step of its unit on top of 2e-5 (as
    tests/test_torch_compressed_round.py)."""
    tp, tparams, tlog, jparams, jlog = _lm_runs(lm_task, compressed=True)
    np.testing.assert_allclose(tlog.losses, jlog.losses, atol=LOSS_TOL,
                               rtol=0)
    assert tlog.meter.uplink_bytes == pytest.approx(jlog.meter.uplink_bytes)
    _assert_frozen_identical(lora_partition(tp), tp, tparams)
    tn = params_to_numpy(tparams)
    part = lora_partition(tp)
    for path in part.trainable_paths:
        got = dict(leaf_paths(tn))[path]
        want = dict(leaf_paths(jparams))[path]
        step = np.abs(want).max() / 127.0
        np.testing.assert_allclose(got, want, atol=PARAM_TOL + step, rtol=0)
    res = tlog.final_state["client"]["residual"]
    assert set(dict(leaf_paths(res))) == set(part.trainable_paths)


def test_lora_drivers_agree_and_uplink_is_trainable_only(lm_task):
    """run_training(sampler="device") equals the engine bit for bit, scan
    mode agrees at 2e-6, and a round uploads n·(adapter unit bytes) +
    K·U·4 divergence bytes."""
    _, tp, _, td = lm_task
    cfg = ModelConfig(**TINY)
    part = lora_partition(tp)
    loss = tfm.make_lm_loss(cfg)
    fl = _lm_fl(FLConfig, partition=part)
    pe, le = run_training_scan(tp, loss, td, fl, rounds=2, seed=1,
                               device="cpu")
    ph, lh = run_training(tp, loss, td, fl, rounds=2, seed=1,
                          sampler="device", device="cpu")
    assert_same(pe, ph)
    assert le.losses == lh.losses
    pq, _ = run_training_scan(tp, loss, td, dataclasses.replace(
        fl, mode="scan"), rounds=2, seed=1, device="cpu")
    assert max_diff(pe, params_to_numpy(pq)) <= EQUIV_TOL
    shards = tdata.ClientShards.from_federated(td)
    assert shards.xs.dtype == shards.ys.dtype == torch.int32
    counts = partition_counts(part, tp)
    units = cfg.num_layers
    unit_bytes = counts["trainable_bytes"] // units
    assert le.meter.uplink_bytes == 2 * (fl.top_n * units * unit_bytes
                                         + LM_K * units * 4)


def test_lora_adapter_uplink_at_least_10x_below_full_model():
    cfg = ModelConfig(**TINY)
    tokens, domains = tdata.make_lm_dataset(num_sequences=64, seq_len=17,
                                            vocab=128, num_domains=4, seed=0)
    data = tdata.lm_federated(tokens, domains, 4)
    params = inject_lora(
        tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
        rank=2, generator=torch.Generator().manual_seed(1))
    part = lora_partition(params)
    fl = FLConfig(algo="fedavg", num_clients=4, clients_per_round=2,
                  top_n=1, batch_per_client=4, partition=part)
    trained, log = run_training(params, tfm.make_lm_loss(cfg), data, fl,
                                rounds=2, seed=0, device="cpu")
    full_bytes = sum(l.numel() * l.element_size()
                     for l in tree_leaves(params))
    full_up = full_bytes * 2                 # K=2 clients, full model
    adapter_up = log.meter.uplink_bytes / 2  # per round
    assert adapter_up * 10 <= full_up
    # the frozen transformer base is returned bit for bit intact
    _, frozen0 = part.split(params)
    _, frozenT = part.split(trained)
    assert_same(frozen0, frozenT)
