"""The port's recurrent and MoE cores (``repro_torch.models.ssm``,
``rglru``, ``moe``) against the JAX package's, on the CPU.

tests/test_recurrence_moe.py's properties, each run on both packages with
the same seeded numpy inputs:
  * SSD chunked scan == the step-by-step recurrence, at any chunk size, and
    a split sequence carrying its state == one pass (the reference's
    2e-3); each port result against the reference's within rtol/atol
    1e-5 (float32; the two sum the quadratic form in their own orders);
  * RG-LRU parallel scan == the sequential gate recurrence and a carried
    state == one pass (the reference's 2e-4); the port's Hillis-Steele
    scan against the reference's odd-even ``associative_scan`` within
    1e-5; bounded states for bounded inputs;
  * MoE dispatch == the explicit top-k mixture when nothing is dropped
    (the reference's 3e-3), overflow past the capacity dropped to exact
    zeros, the load-balance loss >= 1; each against the reference within
    1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests._hypothesis_compat import given, settings, st

from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro_torch.models import moe, rglru, ssm

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(arrays):
    """The same numpy arrays as JAX arrays and as torch tensors."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _near(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _softplus(x):
    return np.logaddexp(x, 0.0)


class TestSSD:
    @staticmethod
    def _inputs(B=2, S=64, H=4, P=8, N=16, seed=0):
        rng = np.random.default_rng(seed)
        f = np.float32
        x = rng.standard_normal((B, S, H, P)).astype(f)
        dt = _softplus(rng.standard_normal((B, S, H)) - 1).astype(f)
        A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(f)
        B_ = (rng.standard_normal((B, S, 1, N)) * 0.3).astype(f)
        C_ = (rng.standard_normal((B, S, 1, N)) * 0.3).astype(f)
        D_ = np.ones(H, f)
        dims = (H * P, H, P, N, 1, 4)
        return (x, dt, A, B_, C_, D_), dims

    def _chunked(self, arrays, dims, chunk, h0=None):
        """(port y, port state), (reference y, reference state)."""
        (j, t) = _pair(list(arrays) + ([] if h0 is None else [h0]))
        got = ssm.ssd_chunked(*t[:6], ssm.SSMDims(*dims), chunk=chunk,
                              initial_state=None if h0 is None else t[6])
        want = jssm.ssd_chunked(*j[:6], jssm.SSMDims(*dims), chunk=chunk,
                                initial_state=None if h0 is None else j[6])
        return got, want

    def test_chunked_equals_stepwise(self):
        arrays, dims = self._inputs()
        (y, final), (jy, jfinal) = self._chunked(arrays, dims, 16)
        _near(y, jy)
        _near(final, jfinal)
        x, dt, A, B_, C_, D_ = map(torch.from_numpy, arrays)
        h = torch.zeros((x.shape[0], x.shape[2], B_.shape[-1], x.shape[3]))
        ys = []
        for t in range(x.shape[1]):
            y_t, h = ssm.ssd_decode_step(
                x[:, t: t + 1], dt[:, t: t + 1], A, B_[:, t: t + 1],
                C_[:, t: t + 1], D_, h)
            ys.append(y_t)
        _near(y, torch.cat(ys, 1), 2e-3)
        _near(final, h, 2e-3)

    @pytest.mark.parametrize("chunk", [8, 16, 32, 64])
    def test_chunk_size_invariance(self, chunk):
        arrays, dims = self._inputs(seed=1)
        (y_ref, f_ref), _ = self._chunked(arrays, dims, 64)
        (y, f), (jy, jf) = self._chunked(arrays, dims, chunk)
        _near(y, jy)
        _near(f, jf)
        _near(y, y_ref, 2e-3)
        _near(f, f_ref, 2e-3)

    def test_initial_state_continuation(self):
        """Splitting a sequence and carrying the state == one full pass."""
        arrays, dims = self._inputs(seed=2)
        (y_full, f_full), _ = self._chunked(arrays, dims, 16)
        cut = 32
        first = [a[:, :cut] if a.ndim > 1 else a for a in arrays]
        second = [a[:, cut:] if a.ndim > 1 else a for a in arrays]
        (y1, f1), _ = self._chunked(first, dims, 16)
        (y2, f2), (jy2, jf2) = self._chunked(second, dims, 16,
                                             h0=f1.numpy())
        _near(y2, jy2)
        _near(f2, jf2)
        _near(torch.cat([y1, y2], 1), y_full, 2e-3)
        _near(f2, f_full, 2e-3)

    def test_ragged_prompt_and_groups_raise(self):
        arrays, dims = self._inputs(S=40)
        with pytest.raises(ValueError, match="multiple of the chunk"):
            self._chunked(arrays, dims, 16)
        x, dt, A, B_, C_, D_ = map(torch.from_numpy, arrays)
        B2 = torch.cat([B_, B_], 2)
        with pytest.raises(ValueError, match="one group"):
            ssm.ssd_decode_step(x[:, :1], dt[:, :1], A, B2[:, :1],
                                B2[:, :1], D_, torch.zeros(2, 4, 16, 8))


class TestRGLRU:
    @staticmethod
    def _params(W=32, seed=0):
        rng = np.random.default_rng(seed)
        f = np.float32
        lp = {"w_a": (rng.standard_normal(W) * 0.5).astype(f),
              "b_a": np.zeros(W, f),
              "w_x": (rng.standard_normal(W) * 0.5).astype(f),
              "b_x": np.zeros(W, f),
              "lam": np.full(W, 0.5, f)}
        return ({k: jnp.asarray(v) for k, v in lp.items()},
                {k: torch.from_numpy(v) for k, v in lp.items()})

    @staticmethod
    def _x(shape, seed):
        return np.random.default_rng(seed + 50).standard_normal(
            shape).astype(np.float32)

    def test_scan_equals_stepwise(self):
        W = 32
        jlp, lp = self._params(W)
        x = self._x((2, 40, W), 1)
        y_scan, h_scan = rglru.rglru_scan(torch.from_numpy(x), lp)
        jy, jh = jrglru.rglru_scan(jnp.asarray(x), jlp)
        _near(y_scan, jy)
        _near(h_scan, jh)
        h = torch.zeros((2, W))
        ys = []
        for t in range(40):
            y_t, h = rglru.rglru_step(torch.from_numpy(x[:, t: t + 1]), lp,
                                      h)
            ys.append(y_t)
        _near(y_scan, torch.cat(ys, 1), 2e-4)
        _near(h_scan, h, 2e-4)

    def test_carried_state_continuation(self):
        W = 16
        jlp, lp = self._params(W, seed=3)
        x = torch.from_numpy(self._x((1, 24, W), 2))
        y_full, h_full = rglru.rglru_scan(x, lp)
        y1, h1 = rglru.rglru_scan(x[:, :10], lp)
        y2, h2 = rglru.rglru_scan(x[:, 10:], lp, h0=h1)
        jy2, jh2 = jrglru.rglru_scan(jnp.asarray(x[:, 10:].numpy()), jlp,
                                     h0=jnp.asarray(h1.numpy()))
        _near(y2, jy2)
        _near(h2, jh2)
        _near(torch.cat([y1, y2], 1), y_full, 2e-4)
        _near(h2, h_full, 2e-4)

    @settings(max_examples=10, deadline=None)
    @given(st.integers(0, 1000))
    def test_prop_stability(self, seed):
        """|a_t| < 1 => bounded state for bounded inputs."""
        W = 8
        jlp, lp = self._params(W, seed=seed % 7)
        x = self._x((1, 200, W), seed)
        y, h = rglru.rglru_scan(torch.from_numpy(x), lp)
        assert bool(torch.isfinite(y).all())
        assert float(h.abs().max()) < 100.0
        _near(h, jrglru.rglru_scan(jnp.asarray(x), jlp)[1])


class TestMoE:
    @staticmethod
    def _mp(D, E, F, seed, scale=0.3):
        rng = np.random.default_rng(seed)
        f = np.float32
        return {"router": (rng.standard_normal((D, E)) * 0.5).astype(f),
                "wg": (rng.standard_normal((E, D, F)) * scale).astype(f),
                "wi": (rng.standard_normal((E, D, F)) * scale).astype(f),
                "wo": (rng.standard_normal((E, F, D)) * scale).astype(f)}

    @staticmethod
    def _both(x, mp, E, K, cf):
        got = moe.moe_ffn(torch.from_numpy(x),
                          {k: torch.from_numpy(v) for k, v in mp.items()},
                          E, K, capacity_factor=cf)
        want = jmoe.moe_ffn(jnp.asarray(x),
                            {k: jnp.asarray(v) for k, v in mp.items()},
                            E, K, capacity_factor=cf)
        _near(got, want)
        return got

    def test_dense_mixture_equivalence(self):
        """With capacity >= tokens, dispatch == explicit top-k mixture."""
        B, S, D, E, K, F = 2, 16, 8, 4, 2, 12
        rng = np.random.default_rng(0)
        x = (rng.standard_normal((B, S, D)) * 0.5).astype(np.float32)
        mp = self._mp(D, E, F, 1)
        with moe.count_drops() as drops:
            y = self._both(x, mp, E, K, 8.0)
        assert [int(d) for d, _ in drops] == [0]
        # explicit reference: every token through its top-k experts
        logits = x @ mp["router"]
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        order = np.argsort(-probs, axis=-1, kind="stable")[..., :K]
        ref = np.zeros((B, S, D), np.float32)
        for b in range(B):
            for s in range(S):
                gv = probs[b, s, order[b, s]]
                gv = gv / gv.sum()
                for j, e in enumerate(order[b, s]):
                    v = x[b, s]
                    g = v @ mp["wg"][e]
                    h = g / (1 + np.exp(-g)) * (v @ mp["wi"][e])
                    ref[b, s] += gv[j] * (h @ mp["wo"][e])
        np.testing.assert_allclose(y.numpy(), ref, rtol=3e-3, atol=3e-3)

    def test_capacity_drops_overflow(self):
        """capacity_factor -> 0 forces drops; output stays finite and
        dropped tokens contribute zero."""
        B, S, D, E, K, F = 1, 32, 8, 2, 1, 8
        rng = np.random.default_rng(1)
        x = rng.standard_normal((B, S, D)).astype(np.float32)
        mp = self._mp(D, E, F, 2, scale=1.0)
        mp["router"] = np.zeros((D, E), np.float32)
        mp["router"][0, 0] = 10.0  # nearly all -> expert 0
        with moe.count_drops() as drops:
            y = self._both(x, mp, E, K, 0.25)
        assert bool(torch.isfinite(y).all())
        zero_rows = float((y == 0).all(-1).float().mean())
        assert zero_rows > 0.3
        (dropped, total), = drops
        assert total == B * S * K and int(dropped) == round(zero_rows * S)

    def test_load_balance_loss(self):
        D, E = 8, 4
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 64, D)).astype(np.float32)
        router = rng.standard_normal((D, E)).astype(np.float32)
        loss = float(moe.aux_load_balance_loss(torch.from_numpy(x),
                                               torch.from_numpy(router), E,
                                               2))
        assert loss >= 1.0 - 1e-3  # >= 1 by Cauchy-Schwarz
        _near(loss, jmoe.aux_load_balance_loss(jnp.asarray(x),
                                               jnp.asarray(router), E, 2))

    def test_ties_route_to_the_lower_expert(self):
        """A zero router ties every expert: ``lax.top_k`` takes the lowest
        indices, and so does the port (``torch.topk`` need not)."""
        B, S, D, E, K, F = 1, 8, 4, 4, 2, 4
        x = np.random.default_rng(3).standard_normal(
            (B, S, D)).astype(np.float32)
        mp = self._mp(D, E, F, 4)
        mp["router"] = np.zeros((D, E), np.float32)
        _, _, idx = moe._route(torch.from_numpy(x),
                               torch.from_numpy(mp["router"]), K)
        assert idx.tolist() == [[[0, 1]] * S]
        self._both(x, mp, E, K, 1.25)
