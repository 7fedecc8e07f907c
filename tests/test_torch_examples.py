"""The port's examples (``examples/*_torch.py``) against the reference's
steps on the CPU, on the same injected draws: the reference's
``PRNGKey`` params through the bridge, its batches and its uniforms.

This file: ``quickstart_torch.py`` (one round step by step: the local
losses, the divergence matrix, the selection, the new params and the
round's bytes), its ``main`` with ``--device cpu``, and a subprocess that
imports all six port examples without loading JAX or the reference
package. ``tests/test_torch_examples_strategies.py`` holds
``custom_strategy_torch.py`` and ``fedlama_fl_torch.py``,
``tests/test_torch_examples_fl.py`` ``fl_cifar_vgg_torch.py`` and
``compressed_fl_torch.py``, ``tests/test_torch_examples_llm.py``
``serve_llm_torch.py``.
"""
import importlib.util
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from test_torch_engine import (LOSS_TOL, PARAM_TOL, max_diff,  # noqa: E402
                               to_torch)

import repro.federated as jfed  # noqa: E402
from repro.core import UnitMap as JUnitMap  # noqa: E402
from repro.core import aggregate_stacked as jaggregate  # noqa: E402
from repro.core import round_comm as jround_comm  # noqa: E402
from repro.core import topn_divergence as jtopn  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
PORTED = ("quickstart", "compressed_fl", "custom_strategy", "fedlama_fl",
          "fl_cifar_vgg", "serve_llm")


def load_example(name):
    """A fresh module of ``examples/<name>.py`` (run again on every call,
    so a registering example registers again)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------------
# quickstart
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def quickstart():
    """The reference quickstart's round, step by step, on its own draws
    (params ``PRNGKey(0)``, batch ``PRNGKey(1)``), and the port's
    ``round_step`` on the same params and batch."""
    qs = load_example("quickstart_torch")
    cfg = jcnn.VGGConfig().reduced()
    jp = jcnn.init_params(jax.random.PRNGKey(0), cfg)
    key = jax.random.PRNGKey(1)
    batch = {"images": jax.random.normal(key, (qs.K, 8, 32, 32, 3)),
             "labels": jax.random.randint(key, (qs.K, 8), 0,
                                          cfg.num_classes)}
    sizes = jnp.array([100.0, 150.0, 80.0, 120.0, 100.0])
    umap = JUnitMap.build(jp)
    local_update = jfed.make_local_update(
        lambda p, b: jcnn.classify_loss(p, cfg, b), jsgd(0.05),
        local_steps=1)

    @jax.jit     # the reference example's steps, in one program
    def steps(jp, batch, sizes):
        locals_, losses = jax.vmap(local_update, in_axes=(None, 0))(jp,
                                                                    batch)
        divs = jax.vmap(lambda p: umap.divergence(p, jp))(locals_)
        sel = jtopn(divs, qs.N_TOP)
        return {"losses": losses, "divergence": divs, "selection": sel,
                "params": jaggregate(locals_, umap, sel, sizes,
                                     fallback=jp),
                "comm": jround_comm(sel, umap)}

    ref = steps(jp, batch, sizes)
    got = qs.round_step(
        tcnn.VGGConfig().reduced(), to_torch(jp),
        {k_: torch.from_numpy(np.array(v)) for k_, v in batch.items()},
        torch.from_numpy(np.array(sizes)))
    return qs, ref, got


def test_quickstart_round_step_matches_reference(quickstart):
    _, ref, got = quickstart
    np.testing.assert_allclose(got["losses"].detach().numpy(),
                               np.asarray(ref["losses"]), atol=LOSS_TOL,
                               rtol=0)
    np.testing.assert_allclose(got["divergence"].numpy(),
                               np.asarray(ref["divergence"]),
                               atol=PARAM_TOL, rtol=0)
    np.testing.assert_array_equal(got["selection"].numpy(),
                                  np.asarray(ref["selection"]))
    assert max_diff(got["params"], jax.tree.map(np.asarray,
                                                ref["params"])) <= PARAM_TOL
    assert set(got["comm"]) == set(ref["comm"])
    for key in ref["comm"]:
        assert float(got["comm"][key]) == float(ref["comm"][key]), key


def test_quickstart_main_on_the_cpu(quickstart, capsys):
    qs = quickstart[0]
    log = qs.main(["--device", "cpu", "--rounds", "2"])
    assert len(log.losses) == 2 and all(np.isfinite(log.losses))
    out = capsys.readouterr().out
    assert "selection (exactly n=2 per column)" in out
    assert "--- 2 rounds with run_training_scan ---" in out


# ----------------------------------------------------------------------
# the examples stand alone
# ----------------------------------------------------------------------
def test_port_examples_import_no_jax():
    """All six port examples, imported in a fresh process: no ``jax`` and
    no module of the reference package ``repro`` is loaded."""
    code = (
        "import importlib.util, os, sys\n"
        f"for name in {PORTED!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, os.path.join(sys.argv[1], name + '_torch.py'))\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    res = subprocess.run([sys.executable, "-c", code, EXAMPLES], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == "[]"
