"""The port's entry points (``entry.py``) against the root
``__graft_entry__.py`` on the CPU.

``entry()``'s solve, in float64 in both packages (the JAX entry's solver
built by its own ``_build`` at float64, its example arguments cast) on the
same arguments, agrees on U, X and the cost within 1e-9
(``tests/test_torch_per_scenario.py``'s rule for U; measured 5.8e-13, 1.1e-12
in X, 0 in the cost).  ``dryrun_multichip(2, device="cpu")``, the mesh phases
and the 2-process farm, is in the slow tier, as the JAX test
of its dry run is."""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu_torch import interop
from mpc_quad_ros_tpu_torch.entry import dryrun_multichip, entry

from test_torch_common import as_numpy

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-9


def jax_entry_module():
    spec = importlib.util.spec_from_file_location("__graft_entry__", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_matches_the_jax_entry(monkeypatch):
    mod = jax_entry_module()
    monkeypatch.setattr(mod, "_build", functools.partial(mod._build, jnp.float64))
    jfn, jargs = mod.entry()
    jargs = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jargs)
    ref = jax.jit(jfn)(*jargs)

    fn, args = entry(device="cpu", dtype=torch.float64)
    X, U, zl, zu, x0, y_ref, rgp = args
    assert zl is None and zu is None and X.shape == (11, 13)
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jargs[4]))
    np.testing.assert_array_equal(y_ref.numpy(), np.asarray(jargs[5]))
    # the solves take the JAX entry's arguments: its carry's U is u_ref
    # rounded to float32 (its x0 is float32), and torch.linspace and
    # jnp.linspace differ by an ulp at 3 of the 10 basis vectors
    np.testing.assert_allclose(U.numpy(), np.asarray(jargs[1]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(rgp.X.numpy(), np.asarray(jargs[6].X), rtol=0, atol=2e-15)
    same = [torch.as_tensor(np.asarray(a)) for a in jargs[:2]] + [None, None, x0, y_ref]
    outs = fn(*same, interop.rgp_state_from_numpy(as_numpy(jargs[6])))
    for name, ours, theirs in zip(("U", "X", "cost"), outs, ref):
        assert ours.dtype == torch.float64 and tuple(ours.shape) == theirs.shape, name
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=TOL,
                                   err_msg=name)
    assert float(outs[0].min()) >= 0.0 and float(outs[0].max()) <= 1.0 + 1e-12


def test_entry_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


@pytest.mark.slow
def test_dryrun_multichip_on_cpu_shards():
    out = dryrun_multichip(2, device="cpu")
    assert out["mesh_shards"] == 2 and out["processes"] == 2 and out["backend"] == "gloo"
    assert out["launches"] == {}   # CPU tensors take the plain versions
    assert all(np.isfinite(out[k]) for k in ("sq_err_sum", "fused_kkt_sum", "riccati_kkt_sum",
                                             "mp_kkt_sum"))
