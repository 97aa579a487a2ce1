"""Public names of the JAX package that the port also has, each on the
port's own format, against the JAX function: ``param_count``,
``make_eval_nll`` and the ``FeatureBank`` methods ``to_device`` /
``to_device_sharded`` (ROADMAP.md lists the names not ported, with the
reason)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stvd.data.bank import FeatureBank as JFeatureBank
from stvd.model.decoder import init_params as jinit_params
from stvd.model.decoder import param_count as jparam_count
from stvd.train import loop as jloop
from stvd_torch.data.bank import FeatureBank, synthetic_bank
from stvd_torch.model.convert import params_from_numpy
from stvd_torch.model.decoder import param_count
from stvd_torch.train import loop as tloop

from test_torch_step import numpy_params
from test_torch_train import batches, configs

SPATIAL = dict(use_spatial=True, n_regions=4, region_dim=16)


@pytest.mark.parametrize("kw", [{}, SPATIAL], ids=["temporal", "spatial"])
def test_param_count_matches_jax(kw):
    jcfg, _ = configs(**kw)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    p = {k: np.asarray(v) for k, v in jp.items()}
    assert param_count(params_from_numpy(p, "cpu")) == jparam_count(jp)
    assert param_count(p) == jparam_count(jp)


@pytest.mark.parametrize("kw", [{}, SPATIAL], ids=["temporal", "spatial"])
def test_make_eval_nll_matches_jax(kw):
    """The NLL terms of one batch (the last example weighted 0)."""
    jcfg, tcfg = configs(**kw)
    p = numpy_params(jcfg, seed=3)
    jb, tb = batches(jcfg)
    want = jloop.make_eval_nll(jcfg)({k: jnp.asarray(v) for k, v in
                                      p.items()}, jb)
    got = tloop.make_eval_nll(tcfg)(params_from_numpy(p, "cpu"), tb)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-5)


class _Mesh1D:
    """A 1-D DeviceMesh's bookkeeping at one rank."""
    mesh_dim_names = ("data",)

    def __init__(self, size, rank):
        self._size, self._rank = size, rank

    def size(self, dim=None):
        return self._size

    def get_local_rank(self, name=None):
        return self._rank


@pytest.mark.parametrize("spatial", [False, True])
def test_feature_bank_device_methods_match_jax(tmp_path, spatial):
    """``bank.to_device(dtype)`` gives the JAX method's arrays;
    ``bank.to_device_sharded(mesh, dtype)`` on each of 2 ranks gives its
    slice of the JAX method's padded global array."""
    bank = synthetic_bank(5, k=4, d=8, n_regions=3 if spatial else 0,
                          region_dim=2, seed=1)
    path = str(tmp_path / "bank.npz")
    bank.save(path)
    bank = FeatureBank.load(path)
    jbank = JFeatureBank.load(path)
    whole = bank.to_device(torch.bfloat16, device="cpu")
    jwhole = jbank.to_device(dtype=jnp.bfloat16)
    assert sorted(whole) == sorted(jwhole)
    for k, v in whole.items():
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(jwhole[k], np.float32))
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))
    jsharded = jbank.to_device_sharded(jmesh, dtype=jnp.float32)
    for r in range(2):
        part = bank.to_device_sharded(_Mesh1D(2, r), torch.float32,
                                      device="cpu")
        for k, v in part.items():
            want = np.asarray(jsharded[k])[3 * r:3 * (r + 1)]
            np.testing.assert_array_equal(v.numpy(), want)
