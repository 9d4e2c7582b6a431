"""The port's public names against the JAX package's, on the CPU.

Every public name of every module that ``pkgutil.walk_packages`` finds
under ``repro`` exists in its ``repro_torch`` twin, but for an allow-list
of the TPU's block constants; ``repro_torch.engine.batched_ops`` and
``onepass_update_batched`` give the reference's states and samples; the
single-stream ``countsketch_scatter`` gives the reference's table (its
Pallas kernel in interpret mode).  Inputs are made with numpy from a seed
and handed to both packages.

Tolerances: those of ``tests/test_torch_samplers.py`` (seeds, keys and
sample keys identical; tables and transformed frequencies within rtol 2e-5
and atol 2e-5 * max(1, max|want|), since ``-log``/``pow`` differ by a few
ulps between the two CPU math libraries), and for the scatter rtol and
atol 2e-5, the reference kernel tests' own.
"""
import importlib
import pkgutil
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro
import repro.core as jcore
import repro.engine as jengine_pkg
from repro.engine import EngineConfig as JCfg
from repro.engine import engine as jengine
from repro.kernels.countsketch_scatter import countsketch_scatter as jscatter
import repro_torch.core as tcore
import repro_torch.engine as tengine_pkg
from repro_torch.engine import EngineConfig, derive_stream_seeds
from repro_torch.engine import engine as tengine
from repro_torch.kernels import countsketch_scatter as ts
from tests.test_torch_samplers import (SAMPLERS, _assert_close,
                                       _assert_pass2, _assert_samples,
                                       _assert_states, _cfg_kw, _sparse)


def _t(x):
    return torch.tensor(np.array(x))


def _public(module):
    return sorted(n for n in dir(module) if not n.startswith("_"))


# Names of the reference that the port leaves out on purpose, each with its
# reason: the Pallas grids' TPU tiling ((8, 128) vector registers, VMEM
# block sizes).  The port's kernels plan their launches for the H100 in
# ``repro_torch.kernels.tiling`` (``table_plan``, ``grid_1d``), and its
# host packing keeps ``pad_to`` and ``packed_span``.
_TPU_TILING = ("the TPU's block tiling, no counterpart on the card")
_LEFT_OUT = {
    "repro.kernels.tiling": dict.fromkeys(
        ("BLOCK_B", "BLOCK_N", "BLOCK_W", "LANE", "SUBLANE",
         "SINGLE_BLOCK_N", "SINGLE_BLOCK_W", "TRANSFORM_BLOCK_N",
         "fit_block"), _TPU_TILING),
    "repro.kernels.ops": dict.fromkeys(
        ("BLOCK_B", "BLOCK_N", "BLOCK_W", "LANE", "SUBLANE", "fit_block"),
        _TPU_TILING),
}
_MODULES = sorted(m.name for m in pkgutil.walk_packages(repro.__path__,
                                                        "repro."))


def _own_names(module):
    """The public names of a ``repro`` module that belong to the package:
    its ``repro`` submodules, the functions and classes defined in
    ``repro``, and its constants (imported third-party modules, functions
    and classes left out)."""
    names = []
    for name in _public(module):
        value = getattr(module, name)
        if isinstance(value, types.ModuleType):
            if value.__name__.startswith("repro."):
                names.append(name)
            continue
        home = getattr(value, "__module__", None)
        if home is None or home.startswith("repro.") or home == "repro":
            names.append(name)
    return names


@pytest.mark.parametrize("module", _MODULES)
def test_every_module_has_the_references_public_names(module):
    """Each module of the JAX package has its twin in the port, which holds
    every one of its public names (a ``repro`` submodule as the port's own
    twin), but for the allow-list ``_LEFT_OUT``, whose names indeed stay
    out of the port."""
    ref_mod = importlib.import_module(module)
    twin = importlib.import_module("repro_torch" + module[len("repro"):])
    left_out = _LEFT_OUT.get(module, {})
    missing = [n for n in _own_names(ref_mod)
               if n not in left_out and not hasattr(twin, n)]
    assert not missing, f"{twin.__name__} lacks {missing}"
    assert set(left_out) <= set(_own_names(ref_mod))
    assert not [n for n in left_out if hasattr(twin, n)]
    for name in _own_names(ref_mod):
        if isinstance(getattr(ref_mod, name), types.ModuleType):
            got = getattr(twin, name)
            assert isinstance(got, types.ModuleType)
            assert got.__name__ == "repro_torch" + getattr(
                ref_mod, name).__name__[len("repro"):]


def test_kernel_ops_reexports_the_padding_and_ref():
    """``repro_torch.kernels.ops`` re-exports ``pad_to``, ``packed_span``
    and the ``ref`` module, as ``repro.kernels.ops`` does; ``engine.planes``
    holds ``batched_ops``, the engine's."""
    from repro_torch.engine import engine as teng
    from repro_torch.engine import planes as tplanes
    from repro_torch.kernels import ops, ref as tref, tiling

    assert (ops.pad_to, ops.packed_span, ops.ref) == (
        tiling.pad_to, tiling.packed_span, tref)
    assert ops.pad_to(1025, 1024) == 2048 and ops.packed_span(1) == 1024
    assert tplanes.batched_ops is teng.batched_ops


@pytest.mark.parametrize("name", _public(jcore))
def test_core_exports_the_references_names(name):
    """``repro_torch.core`` re-exports what ``repro.core`` does: the ten
    submodules (the port's own), ``Sample``, ``SamplerConfig``,
    ``SamplerSpec`` and ``make_sampler``."""
    got = getattr(tcore, name)
    if isinstance(getattr(jcore, name), type(jcore)):
        assert got.__name__ == f"repro_torch.core.{name}"
    else:
        assert got.__module__.startswith("repro_torch.core.")


def test_core_names_import_from_the_package():
    from repro_torch.core import (Sample, SamplerConfig, SamplerSpec,
                                  make_sampler)
    from repro_torch.core import perfect, sampler

    assert (Sample, SamplerConfig, SamplerSpec, make_sampler) == (
        perfect.Sample, sampler.SamplerConfig, sampler.SamplerSpec,
        sampler.make_sampler)
    spec = make_sampler("onepass", SamplerConfig(rows=3, width=16))
    assert isinstance(spec, SamplerSpec)


def test_engine_exports_the_references_names():
    """Every public name of ``repro.engine`` (its submodules aside) is one
    of ``repro_torch.engine``'s, defined in the port."""
    names = [n for n in _public(jengine_pkg)
             if not isinstance(getattr(jengine_pkg, n), type(jengine_pkg))]
    assert {"BatchedSamplerOps", "batched_ops",
            "onepass_update_batched"} <= set(names)
    missing = [n for n in names if not hasattr(tengine_pkg, n)]
    assert not missing
    assert all(getattr(tengine_pkg, n).__module__.startswith("repro_torch.")
               for n in names)


@pytest.mark.parametrize("name", SAMPLERS)
def test_batched_ops_match_reference(name):
    """``batched_ops(spec)`` of every registered sampler against the
    reference's: init, update, merge, sample, estimate and, for the
    two-phase samplers, init2/update2/merge2/sample2, with the reference's
    call signatures; one cached object per spec."""
    kw = _cfg_kw(name)
    tcfg, jcfg = EngineConfig(**kw), JCfg(**kw)
    tops = tengine_pkg.batched_ops(tengine.engine_spec(tcfg))
    jops = jengine_pkg.batched_ops(jengine.engine_spec(jcfg))
    assert isinstance(tops, tengine_pkg.BatchedSamplerOps)
    assert tops is tengine_pkg.batched_ops(tengine.engine_spec(tcfg))
    ta = tops.init(*derive_stream_seeds(tcfg, device="cpu"))
    ja = jops.init(*jengine.derive_stream_seeds(jcfg))
    _assert_states(ta, ja, float_rtol=0)
    tb, jb = ta, ja
    for step in range(2):
        keys, vals = _sparse(seed=40 + step)
        ta = tops.update(ta, _t(keys), _t(vals))
        ja = jops.update(ja, jnp.asarray(keys), jnp.asarray(vals))
        tb = tops.update(tb, _t(keys[:, ::-1]), _t(vals[:, ::-1]))
        jb = jops.update(jb, jnp.asarray(keys[:, ::-1]),
                         jnp.asarray(vals[:, ::-1]))
    _assert_states(ta, ja)
    tm, jm = tops.merge(ta, tb), jops.merge(ja, jb)
    _assert_states(tm, jm)
    _assert_samples(tops.sample(tm, k=4), jops.sample(jm, k=4),
                    exact_freqs=name in ("perfect", "twopass"))
    _assert_close(tops.estimate(tm, _t(keys)).numpy(),
                  jops.estimate(jm, jnp.asarray(keys)))
    hooks = ("init2", "update2", "merge2", "sample2")
    assert [hasattr(tops, h) for h in hooks] == [hasattr(jops, h)
                                                 for h in hooks]
    if not hasattr(jops, "init2"):
        return
    t2, j2 = tops.init2(tm), jops.init2(jm)
    _assert_states(t2, j2, float_rtol=0)
    t2 = tops.update2(t2, tm, _t(keys), _t(vals))
    j2 = jops.update2(j2, jm, jnp.asarray(keys), jnp.asarray(vals))
    _assert_pass2(t2, j2)
    t2, j2 = tops.merge2(t2, t2), jops.merge2(j2, j2)
    _assert_pass2(t2, j2)
    _assert_samples(tops.sample2(t2, k=4), jops.sample2(j2, k=4),
                    exact_freqs=True)


@pytest.mark.parametrize("p,scheme", [(1.0, "ppswor"), (0.5, "priority"),
                                      (2.0, "ppswor")])
def test_onepass_update_batched_matches_reference(p, scheme):
    """Two steps of ``onepass_update_batched`` from the engine's initial
    one-pass state, then the batched sample, in both packages."""
    kw = _cfg_kw("onepass", p=p, scheme=scheme)
    tcfg, jcfg = EngineConfig(**kw), JCfg(**kw)
    tst = tengine.onepass_init_batched(tcfg, device="cpu")
    jst = jengine.onepass_init_batched(jcfg)
    for step in range(2):
        keys, vals = _sparse(seed=50 + step)
        tst = tengine_pkg.onepass_update_batched(tst, _t(keys), _t(vals), p,
                                                 scheme)
        jst = jengine_pkg.onepass_update_batched(jst, jnp.asarray(keys),
                                                 jnp.asarray(vals), p,
                                                 scheme)
    _assert_states(tst, jst)
    _assert_samples(tengine.onepass_sample_batched(tst, 6, p, scheme),
                    jengine.onepass_sample_batched(jst, 6, p, scheme))


# (n, p, scheme, transform seed, padding slots): single-stream scatters
SCATTER_CASES = {
    "no_transform": (300, None, "ppswor", 0, 0),
    "ppswor_p1": (300, 1.0, "ppswor", 2**32 - 7, 0),
    "priority_half": (257, 0.5, "priority", 99, 0),
    "padding": (300, 2.0, "ppswor", 5, 40),
}


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_single_stream_scatter_matches_reference(case):
    """``countsketch_scatter`` (one stream, the CPU's plain version) against
    the reference's single-stream wrapper in interpret mode: (rows, width)
    tables within rtol and atol 2e-5; repeated keys accumulate, keys -1
    are padding, and no kernel launch is counted on the CPU."""
    n, p, scheme, tseed, pad = SCATTER_CASES[case]
    rng = np.random.default_rng(n + pad)
    keys = rng.integers(0, 60, n).astype(np.int32)   # many repeats
    keys[rng.permutation(n)[:pad]] = -1
    vals = rng.normal(size=n).astype(np.float32)
    seed = 2**32 - 3
    before = (ts.launches, ts.single_launches, dict(ts.variant_launches))
    got = ts.countsketch_scatter(_t(keys), _t(vals), 5, 256, seed, p=p,
                                 scheme=scheme, transform_seed=tseed)
    assert (ts.launches, ts.single_launches,
            dict(ts.variant_launches)) == before
    want = np.asarray(jscatter(jnp.asarray(keys), jnp.asarray(vals), 5, 256,
                               jnp.uint32(seed), p=p, scheme=scheme,
                               transform_seed=jnp.uint32(tseed),
                               interpret=True))
    assert got.shape == want.shape == (5, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
