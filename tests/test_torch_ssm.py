"""The port's SSM, hybrid and audio families (models/mamba2.py, the hybrid
stack, the audio encoder-decoder, frames_stub) against the jitted
reference, on the CPU. Their prefill and decode are held in
tests/test_torch_serve.py.

Tolerances (ROADMAP Queue 3, items 11 and 12), with the largest errors
seen:
  - segsum: -inf exactly above the diagonal, the finite entries within
    1e-6 of their max (XLA's cumsum associates differently; seen 6.2e-8),
    _causal_conv within 1e-6 of max |y| (f32; seen 7.0e-8), its state
    bitwise;
  - ssd_chunked within 1e-5 of max |y| and of max |state| against the
    reference and against the token-by-token recurrence (mamba2_decode's
    update), the padding branch (S = 12, chunk 8; S = 5 < chunk) and an
    initial state included (seen 1.4e-7 and 2.1e-7);
  - Model.loss of the SSM, hybrid and audio smoke configs within 1e-5
    relative (seen 1.4e-7) and every gradient leaf within 1e-4 of its max
    |g| (seen 2.2e-5, zamba2's conv_x).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_ref import jkey, reference

SSM_MODULES = ("repro.models.model", "repro.models.layers",
               "repro.models.mamba2", "repro.configs.registry",
               "repro.models.config")
LOSS_ARCHS = ["mamba2-1.3b", "zamba2-7b", "whisper-base"]
B, S = 4, 24


def ssm_reference():
    return reference(*SSM_MODULES)


def _close_to_max(got, want, frac, what=""):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = frac * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, (what, err, bound)


def test_segsum_and_causal_conv():
    from repro_torch.models import mamba2
    rng = np.random.default_rng(0)
    x = -np.abs(rng.standard_normal((2, 3, 8))).astype(np.float32)
    xc = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((12, 4)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    with ssm_reference() as ref:
        want = np.asarray(jax.jit(ref.mamba2.segsum)(x))
        wy, ws = jax.jit(ref.mamba2._causal_conv)(xc, w, st)
        wy0, ws0 = jax.jit(ref.mamba2._causal_conv)(xc, w)
    got = mamba2.segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    _close_to_max(torch.from_numpy(got[fin]), want[fin], 1e-6, "segsum")
    for state, (y_w, s_w) in ((torch.from_numpy(st), (wy, ws)),
                              (None, (wy0, ws0))):
        y, s = mamba2._causal_conv(torch.from_numpy(xc), torch.from_numpy(w),
                                   state)
        _close_to_max(y, y_w, 1e-6, "conv y")
        assert np.array_equal(s.numpy(), np.asarray(s_w))


def _recurrence(xh, dt, A, Bm, Cm, D, state):
    """The token-by-token SSM recurrence (mamba2_decode's update):
    state = exp(dt A) state + dt B x; y = C . state + D x."""
    ys = []
    for t in range(xh.shape[1]):
        g = torch.exp(dt[:, t] * A[None, :])
        upd = (dt[:, t, :, None] * xh[:, t])[..., None] * Bm[:, t, None,
                                                                None, :]
        state = g[..., None, None] * state + upd
        y = torch.einsum("bn,bhpn->bhp", Cm[:, t], state)
        ys.append(y + D[None, :, None] * xh[:, t])
    return torch.stack(ys, dim=1), state


@pytest.mark.parametrize("S_,chunk,init", [(16, 8, False), (12, 8, False),
                                           (12, 8, True), (5, 8, True)])
def test_ssd_chunked_matches_reference_and_recurrence(S_, chunk, init):
    from repro_torch.models import mamba2
    rng = np.random.default_rng(S_ + int(init))
    Bz, H, P, N = 2, 3, 4, 5
    xh = rng.standard_normal((Bz, S_, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bz, S_, H)))).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm, Cm = (rng.standard_normal((Bz, S_, N)).astype(np.float32)
              for _ in range(2))
    D = rng.standard_normal(H).astype(np.float32)
    s0 = (rng.standard_normal((Bz, H, P, N)).astype(np.float32)
          if init else None)
    with ssm_reference() as ref:
        wy, ws = jax.jit(ref.mamba2.ssd_chunked, static_argnums=6)(
            xh, dt, A, Bm, Cm, D, chunk, s0)
    t = [torch.from_numpy(a) for a in (xh, dt, A, Bm, Cm, D)]
    ts0 = torch.from_numpy(s0) if init else None
    y, state = mamba2.ssd_chunked(*t, chunk, init_state=ts0)
    _close_to_max(y, wy, 1e-5, "y")
    _close_to_max(state, ws, 1e-5, "state")
    ry, rs = _recurrence(*t, ts0 if init else torch.zeros((Bz, H, P, N)))
    _close_to_max(y, ry.numpy(), 1e-5, "y vs recurrence")
    _close_to_max(state, rs.numpy(), 1e-5, "state vs recurrence")


@pytest.fixture(scope="module")
def reference_losses():
    """The SSM, hybrid and audio smoke losses and gradients, jitted."""
    out = {}
    with ssm_reference() as ref:
        for arch in LOSS_ARCHS:
            jcfg = ref.registry.get_smoke(arch)
            jm = ref.model.Model(jcfg, ref.model.DistConfig())
            jp = jm.init(jkey(0))
            rng = np.random.default_rng(1)
            b = {"tokens": rng.integers(0, jcfg.vocab, (B, S)).astype(
                np.int32),
                 "targets": rng.integers(0, jcfg.vocab, (B, S)).astype(
                     np.int32)}
            if jcfg.arch_type == "audio":
                b["frames"] = (0.02 * rng.standard_normal(
                    (B, jcfg.frontend_seq, jcfg.d_model))).astype(np.float32)
            jl, jg = jax.jit(jax.value_and_grad(
                lambda p, b: jm.loss(p, b, jkey(1))))(jp, b)
            out[arch] = (jcfg, jax.tree_util.tree_map(np.asarray, jp), b,
                         float(jl), [np.asarray(g) for g in
                                     jax.tree_util.tree_leaves(jg)])
    return out


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_gradients_match_reference(arch, reference_losses):
    from repro_torch.convert import (params_from_jax, tree_leaves,
                                     tree_paths, tree_unflatten)
    from repro_torch.models import DistConfig, Model
    from repro_torch.models.config import ModelConfig
    jcfg, jp, b, jl, jg = reference_losses[arch]
    m = Model(ModelConfig(**dataclasses.asdict(jcfg)), DistConfig())
    tp = params_from_jax(jp, device="cpu")
    leaves = [l.requires_grad_(True) for l in tree_leaves(tp)]
    loss = m.loss(tree_unflatten(tree_paths(tp), leaves),
                  {k: torch.from_numpy(v) for k, v in b.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), jl, rtol=1e-5)
    assert len(grads) == len(jg)
    for path, g, want in zip(tree_paths(tp), grads, jg):
        _close_to_max(g, want, 1e-4, "/".join(path))


def test_loss_without_remat_is_bitwise():
    """remat recomputes the same ops on the hybrid's groups and the
    SSM tail: gradients bitwise with and without it."""
    from repro_torch import random as R
    from repro_torch.configs import get_smoke
    from repro_torch.convert import tree_leaves, tree_paths, tree_unflatten
    from repro_torch.models import DistConfig, Model
    cfg = get_smoke("zamba2-7b")
    m = Model(cfg, DistConfig())
    p = m.init(R.key(1), device="cpu")
    assert "tail_blocks" in p
    rng = np.random.default_rng(2)
    b = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 10)))
         for k in ("tokens", "targets")}
    out = []
    for remat in (True, False):
        leaves = [l.clone().requires_grad_(True) for l in tree_leaves(p)]
        loss = m.loss(tree_unflatten(tree_paths(p), leaves), b, remat=remat)
        out.append(torch.autograd.grad(loss, leaves))
    assert all(torch.equal(a, c) for a, c in zip(*out))


def test_frames_stub():
    from repro_torch import random as R
    from repro_torch.data import frames_stub
    a = frames_stub(R.key(4), 2, 24, 16, device="cpu")
    assert a.shape == (2, 24, 16) and a.dtype == torch.float32
    assert torch.equal(a, frames_stub(R.key(4), 2, 24, 16, device="cpu"))
    assert 0.01 < float(a.std()) < 0.03
    with pytest.raises(RuntimeError, match="no CUDA device"):
        frames_stub(R.key(4), 2, 24, 16)


# ---- bf16 against the jitted reference (ROADMAP Queue 3, item 14) -------------

def _bf16(a) -> torch.Tensor:
    from repro_torch.convert import tensor_from_numpy
    return tensor_from_numpy(np.asarray(a))


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def test_bf16_gelu_bitwise():
    """In bf16 the reference's jitted jax.nn.gelu (tanh form) rounds each
    step of its expansion x * 0.5 * (1 + tanh(c (x + a (x * x) * x))) to
    bf16, with a and c rounded to bf16; the port does the same
    (layers.gelu). So gelu is bitwise on every bf16 value from 2^-120 in
    magnitude (63,488 finite values; +inf gives +inf and -inf a NaN on both
    sides, with other NaN payloads): below that XLA flushes subnormal
    inputs and results (outside the contract as in item 5).
    F.gelu(approximate="tanh"), which the port called before, rounds once:
    it differed on 1,010 of those values, x from -5.03 to 2.31, where for
    x below about -3 XLA's rounded tanh is -1 and its product -0.0."""
    import jax.numpy as jnp
    from repro_torch.models.layers import gelu
    bits = np.arange(1 << 16, dtype=np.uint16)
    xs = bits.view(jnp.bfloat16)
    xf = xs.astype(np.float32)
    keep = np.isfinite(xf) & (np.abs(xf) >= np.float32(2.0 ** -120))
    want = jax.jit(jax.nn.gelu)(jnp.asarray(xs))
    got = gelu(_bf16(xs))
    assert keep.sum() == 63488
    assert np.array_equal(_bits(got)[keep], _bits(want)[keep])
    inf = np.isinf(xf)
    assert np.array_equal(np.asarray(want, np.float32)[inf],
                          got.to(torch.float32).numpy()[inf],
                          equal_nan=True)
    x32 = torch.from_numpy(xf[keep])
    assert torch.equal(gelu(x32),
                       torch.nn.functional.gelu(x32, approximate="tanh"))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_bf16_silu_and_mamba2_bitwise(arch):
    """In bf16 the reference's jitted jax.nn.silu rounds each step of its
    expanded logistic (exp, 1 + e, 1 / d, x * s) and its step
    `x @ w_dt + dt_bias` stays f32 up to the softplus; the port does the
    same (layers.silu, mamba2._dt_f32). So silu is bitwise on every bf16
    value from 2^-120 in magnitude to -87 (XLA flushes subnormals, outside
    the contract as in item 5). On the smoke configs' first layer in bf16,
    a mamba2_block has at most 0.1% of its outputs apart, within 1e-3 of
    max |out| (seen 0.03%, 3.0e-4: the f32 SSD sums in another order
    before its bf16 cast), and a mamba2_decode step's output is bitwise,
    its conv states at most 0.1% apart (the bf16 projections' sums) and
    its SSM state within 1e-5 of its max."""
    import jax.numpy as jnp
    from repro_torch.convert import params_from_jax
    from repro_torch.models import DistConfig, mamba2
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.layers import silu
    bits = np.arange(1 << 16, dtype=np.uint16)
    xs = bits.view(jnp.bfloat16)
    # XLA's CPU code flushes subnormals, and results at the smallest
    # normal binades with them; below x = -87 its 1 / d is subnormal
    xf = xs.astype(np.float32)
    keep = (np.abs(xf) >= np.float32(2.0 ** -120)) & (xf > -87)
    rng = np.random.default_rng(6)
    with ssm_reference() as ref:
        want_silu = _bits(jax.jit(jax.nn.silu)(jnp.asarray(xs)))
        jcfg = dataclasses.replace(ref.registry.get_smoke(arch),
                                   dtype="bfloat16")
        jm = ref.model.Model(jcfg, ref.model.DistConfig())
        layer = jax.tree_util.tree_map(lambda w: np.asarray(w[0]),
                                       jm.init(jkey(0))["blocks"])
        d_in = jcfg.ssm_expand * jcfg.d_model
        N, K = jcfg.ssm_state, jcfg.ssm_conv
        H = d_in // jcfg.ssm_head_dim
        x = jnp.asarray(rng.standard_normal((2, 12, jcfg.d_model)),
                        jnp.bfloat16)
        x1 = jnp.asarray(rng.standard_normal((2, 1, jcfg.d_model)),
                         jnp.bfloat16)
        cx = jnp.asarray(rng.standard_normal((2, K - 1, d_in)), jnp.bfloat16)
        cbc = jnp.asarray(rng.standard_normal((2, K - 1, 2 * N)),
                          jnp.bfloat16)
        st = rng.standard_normal((2, H, jcfg.ssm_head_dim, N)).astype(
            np.float32)
        dj = ref.model.DistConfig()
        want_block = jax.jit(lambda p, x: ref.mamba2.mamba2_block(
            p, x, jcfg, dj))(layer, x)
        want_out, ((wcx, wcbc), wst) = jax.jit(
            lambda p, x, c0, c1, s: ref.mamba2.mamba2_decode(
                p, x, (c0, c1), s, jcfg, dj))(layer, x1, cx, cbc, st)
    got_silu = _bits(silu(_bf16(xs)))
    assert keep.sum() > 47000
    assert np.array_equal(got_silu[keep], want_silu[keep])
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    p = params_from_jax(layer, device="cpu")
    got = mamba2.mamba2_block(p, _bf16(x), cfg, DistConfig())
    assert np.mean(_bits(got) != _bits(want_block)) <= 1e-3
    _close_to_max(got, want_block.astype(np.float32), 1e-3, "block")
    tcx, tcbc, tst = _bf16(cx), _bf16(cbc), torch.from_numpy(st.copy())
    out, _ = mamba2.mamba2_decode(p, _bf16(x1), (tcx, tcbc), tst, cfg,
                                  DistConfig())
    assert np.array_equal(_bits(out), _bits(want_out))
    for got_s, want_s in ((tcx, wcx), (tcbc, wcbc)):
        assert np.mean(_bits(got_s) != _bits(want_s)) <= 1e-3
    _close_to_max(tst, np.asarray(wst), 1e-5, "ssm state")
