"""optim/ against the reference: every optimizer (SGD, momentum with and
without Nesterov, Adam), with and without weight decay, 3 chained steps on
resnet9's parameter shapes, bitwise against the reference's JITTED
apply_updates (XLA's CPU fma contractions and its algebraic simplifier's
Adam step, optim/optimizers.py); the global-norm clip to a tolerance (its
norm sums in another order); Adam's bias correction bitwise below the
counts where XLA's f32 pow first differs from the f64-rounded power, one
ulp beyond; and the constant, cosine and piecewise-linear schedules.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ref import reference
from test_torch_wire import RESNET9_SHAPES, _grads, _to_jax, _to_torch

CONFIGS = [dict(name="sgd"), dict(name="sgd", weight_decay=5e-4),
           dict(name="momentum"), dict(name="momentum", weight_decay=5e-4),
           dict(name="momentum", nesterov=True),
           dict(name="momentum", nesterov=True, weight_decay=5e-4),
           dict(name="adam"), dict(name="adam", weight_decay=5e-4),
           dict(name="adam", beta1=0.8, beta2=0.99, eps=1e-6)]


def _leaves(tree):
    from repro_torch.convert import tree_leaves
    return [np.asarray(leaf) for leaf in tree_leaves(tree)]


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _run(kw, steps=3, seed=0):
    """`steps` updates of the port and of the reference's jitted update
    on the same seeded gradients -> [(port params, reference params,
    port state, reference state)] a step."""
    from repro_torch.optim import OptConfig, apply_updates, init_opt_state
    p_np = _grads(RESNET9_SHAPES, seed=seed, dyadic=False)
    params = _to_torch(p_np)
    cfg = OptConfig(lr=0.05, **kw)
    state = init_opt_state(cfg, params)
    out = []
    with reference():
        from repro.optim import optimizers as O
        jcfg = O.OptConfig(lr=0.05, **kw)
        jparams = _to_jax(p_np)
        jstate = O.init_opt_state(jcfg, jparams)
        jstep = jax.jit(lambda p, g, s, lr: O.apply_updates(jcfg, p, g, s,
                                                            lr))
        for step in range(steps):
            g_np = _grads(RESNET9_SHAPES, seed=100 + step, dyadic=False)
            lr = np.float32(0.05 * (step + 1))
            params, state = apply_updates(cfg, params, _to_torch(g_np),
                                          state, torch.tensor(lr))
            jparams, jstate = jstep(jparams, _to_jax(g_np), jstate,
                                    jnp.float32(lr))
            out.append((params, jparams, state, jstate))
    return out


@pytest.mark.parametrize("kw", CONFIGS,
                         ids=["-".join(f"{k}={v}" for k, v in c.items())
                              for c in CONFIGS])
def test_apply_updates_bitwise_against_jitted_reference(kw):
    for params, jparams, state, jstate in _run(kw):
        for a, b in zip(_leaves(params), _leaves(jparams)):
            assert a.dtype == np.float32
            assert np.array_equal(_bits(a), _bits(b)), \
                float(np.max(np.abs(a - b)))
        for key in ("m", "v"):
            if key in jstate:
                for a, b in zip(_leaves(state[key]), _leaves(jstate[key])):
                    assert np.array_equal(_bits(a), _bits(b)), key
        if "count" in jstate:
            assert int(state["count"]) == int(jstate["count"])
            assert state["count"].dtype == torch.int32


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_global_norm_clip_within_tolerance(name):
    """grad_clip: the clipped gradients to 1e-6 relative (the norm's sum of
    squares runs in another order than jnp.sum), and 5e-4 clips these
    gradients (norm ~ 350); two clipped updates to 1e-6 relative or 5e-8
    absolute (Adam's step is scale-free, so an ulp of the clip scale moves
    its update lr * step, |lr * step| <= ~0.1, by an ulp or two: 7.5e-9
    each)."""
    from repro_torch.optim.optimizers import _clip
    g = _to_torch(_grads(RESNET9_SHAPES, seed=3, dyadic=False))
    clipped = _leaves(_clip(g, 5e-4))
    with reference():
        from repro.optim.optimizers import _clip as jclip
        jclipped = _leaves(jax.jit(lambda t: jclip(t, 5e-4))(
            _to_jax(_grads(RESNET9_SHAPES, seed=3, dyadic=False))))
    for a, b in zip(clipped, jclipped):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    norm = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                       for x in clipped))
    assert abs(norm - 5e-4) < 1e-9
    assert _clip(g, 0.0) is g
    for params, jparams, _, _ in _run(dict(name=name, grad_clip=0.02),
                                      steps=2, seed=4):
        for a, b in zip(_leaves(params), _leaves(jparams)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=5e-8)


def test_adam_bias_correction_against_xla_pow():
    """1 - beta ** count: the port rounds the power from f64 on the host.
    XLA's f32 pow gives the same bits for every count below 685 (beta 0.9)
    and 873 (beta 0.999), and at most one ulp off up to 5,000 (ROADMAP.md
    Queue 3)."""
    from repro_torch.optim.optimizers import _bias_correction
    counts = np.arange(1, 5001, dtype=np.float32)
    for beta, exact_below in ((0.9, 685), (0.999, 873)):
        xla = np.float32(1) - np.asarray(jax.jit(
            lambda c, b=beta: jnp.float32(b) ** c)(counts))
        port = np.array([_bias_correction(beta, int(c)) for c in counts],
                        np.float32)
        ulps = np.abs(port.view(np.int32).astype(np.int64)
                      - xla.view(np.int32))
        assert not ulps[:exact_below - 1].any(), beta
        assert ulps.max() <= 1, beta


def test_opt_state_and_errors():
    from repro_torch.optim import OptConfig, apply_updates, init_opt_state
    params = {"w": torch.ones(3, dtype=torch.float32)}
    assert init_opt_state(OptConfig("sgd"), params) == {}
    st = init_opt_state(OptConfig("adam"), params)
    assert st["m"]["w"].dtype == torch.float32 and int(st["count"]) == 0
    with pytest.raises(ValueError):
        init_opt_state(OptConfig("lamb"), params)
    with pytest.raises(KeyError):
        apply_updates(OptConfig("lamb"), params, params, {}, 0.1)


@pytest.mark.parametrize("sched", [("constant", (0.03,)),
                                   ("cosine", (0.4, 50)),
                                   ("cosine", (0.4, 50, 7, 0.01)),
                                   ("piecewise_linear", (0.4, 7, 1))])
def test_schedules_match_reference(sched):
    """constant and piecewise-linear bitwise; cosine to 1e-6 relative
    (torch's CPU cos and XLA's differ in the last bits)."""
    from repro_torch.optim import schedules as S
    name, args = sched
    fn = getattr(S, name)(*args)
    with reference():
        from repro.optim import schedules as JS
        jfn = getattr(JS, name)(*args)
        for i in range(0, 60, 3):
            a, b = np.float32(fn(i).item()), np.asarray(jfn(i))
            assert fn(i).dtype == torch.float32
            if name == "cosine":
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
            else:
                assert a == b, (name, i)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_update_in_slices_is_bitwise(name, monkeypatch):
    """A leaf of more than optimizers.CHUNK entries updates slice by slice
    (bounded temporaries at full width): the same bits as one slice."""
    from repro_torch.convert import tree_leaves
    from repro_torch.optim import optimizers as O
    rng = np.random.default_rng(4)
    ps = {"w": torch.from_numpy(rng.standard_normal((97, 41)).astype(
              np.float32)),
          "g": torch.from_numpy(rng.standard_normal(7).astype(
              np.float32)).to(torch.bfloat16)}
    gs = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
              np.float32)).to(v.dtype) for k, v in ps.items()}
    cfg = O.OptConfig(name=name, lr=0.1, weight_decay=0.01, nesterov=True)
    _, st = O.apply_updates(cfg, ps, gs, O.init_opt_state(cfg, ps), 0.1)
    whole = O.apply_updates(cfg, ps, gs, st, torch.tensor(0.05))
    monkeypatch.setattr(O, "CHUNK", 500)
    sliced = O.apply_updates(cfg, ps, gs, st, torch.tensor(0.05))
    for a, b in zip(tree_leaves(whole[0]) + tree_leaves(whole[1]),
                    tree_leaves(sliced[0]) + tree_leaves(sliced[1])):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert a.numpy().tobytes() == b.numpy().tobytes()
