"""The port's LM train path on one device (models/, configs/, the LM data
and the bf16 conversion) against the reference, on the CPU.

Inputs are made with numpy from a seed (or by the reference's own init),
converted with params_from_jax, and fed to both sides. The reference's
loss and gradients are jitted, as its callers run them.

Tolerances (ROADMAP Queue 3, item 11):
  - declare_params, the registry and build_plan: equal (shapes, masks,
    counts, unit tables and fold tables) for all ten archs;
  - RoPE frequencies bitwise (XLA's jitted theta ** (-i / half) is the f64
    power of -i * f32(1 / half), rounded to f32); rope itself within 2 f32
    ulps of |x| (XLA's and torch's cos / sin and contractions differ);
  - rmsnorm / layernorm in f32 within 1e-6 relative; rmsnorm in bf16 at
    most 2% of entries one bf16 ulp apart;
  - flash_attention forward within 1e-6 and its gradients within 1e-5 of
    max |g| against the reference and against chunked_attention;
  - moe_ffn, the loss and every gradient leaf in f32: loss within 1e-5
    relative, each gradient leaf within 1e-4 of its max |g| (matmul and
    reduction orders differ; observed 1.4e-7 and 2.3e-6);
  - the bf16 loss within 1e-3 relative and each gradient leaf within 5e-2
    of its max |g| (bf16 rounds at every op; observed 2.1e-4 and 2.1e-2,
    a few ulps of bf16's 2**-8).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ref import buckets, jkey, reference

LM_MODULES = ("repro.models.model", "repro.models.layers",
              "repro.models.flash", "repro.models.moe",
              "repro.configs.registry", "repro.models.config")
ARCHS = ["qwen3-moe-235b-a22b", "llama3-405b", "phi4-mini-3.8b", "zamba2-7b",
         "whisper-base", "internvl2-2b", "granite-20b", "minicpm3-4b",
         "mamba2-1.3b", "llama4-maverick-400b-a17b"]
# the attention families' smoke configs, plus phi4-mini with a sliding
# window shorter than the sequence (its LONG_CONTEXT's swa_pattern=0
# form) and a bf16 llama3
LOSS_CASES = [("qwen3-moe-235b-a22b", None), ("llama3-405b", None),
              ("phi4-mini-3.8b", None), ("internvl2-2b", None),
              ("granite-20b", None), ("minicpm3-4b", None),
              ("llama4-maverick-400b-a17b", None), ("phi4-mini-3.8b", "swa"),
              ("llama3-405b", "bf16")]
B, S = 4, 24


def lm_reference():
    return reference(*LM_MODULES)


def _port_cfg(jcfg):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**dataclasses.asdict(jcfg))


def _t(a) -> torch.Tensor:
    from repro_torch.convert import tensor_from_numpy
    return tensor_from_numpy(np.asarray(a))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _close_to_max(got, want, frac, what=""):
    """Every entry within frac x max |want|."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = frac * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bound, (what, err, bound)


def _leaf_shapes(tree):
    from repro_torch.convert import tree_leaves, tree_paths
    return {p: tuple(l.shape) for p, l in zip(tree_paths(tree),
                                              tree_leaves(tree))}


# ---- configs, declaration and plans ------------------------------------------

def test_registry_matches_reference():
    from repro_torch.configs import registry
    from repro_torch.models.config import INPUT_SHAPES
    with lm_reference() as ref:
        assert registry.ARCH_NAMES == ref.registry.ARCH_NAMES == tuple(ARCHS)
        assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} \
            == {k: dataclasses.asdict(v)
                for k, v in ref.config.INPUT_SHAPES.items()}
        mine, theirs = list(registry.all_pairs()), list(
            ref.registry.all_pairs())
        assert len(mine) == len(theirs) == 40
        for (a, s, c, n), (ja, js, jc, jn) in zip(mine, theirs):
            assert (a, s, n) == (ja, js, jn)
            assert (c is None) == (jc is None)
            if c is not None:
                assert dataclasses.asdict(c) == dataclasses.asdict(jc)
        for arch in ARCHS:
            for get in ("get_smoke", "get_long_context"):
                a, b = getattr(registry, get)(arch), getattr(ref.registry,
                                                             get)(arch)
                assert (a is None) == (b is None)
                if a is not None:
                    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    with pytest.raises(ValueError, match="unknown arch"):
        registry.get_config("gpt-2")


@pytest.mark.parametrize("arch", ARCHS)
def test_declare_params_match_reference(arch):
    """Full and smoke configs: every leaf's shape, dtype and metadata, the
    stacked and tp-sync masks, and the analytic parameter counts."""
    from repro_torch.configs import registry
    from repro_torch.models import DistConfig, Model
    from repro_torch.models.params import torch_dtype
    with lm_reference() as ref:
        for get in ("get_config", "get_smoke"):
            jcfg = getattr(ref.registry, get)(arch)
            cfg = getattr(registry, get)(arch)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            jm = ref.model.Model(jcfg, ref.model.DistConfig())
            m = Model(cfg, DistConfig())
            jshapes = jm.param_shapes()
            shapes = m.param_shapes()
            want = {tuple(k.key for k in p): tuple(l.shape)
                    for p, l in jax.tree_util.tree_leaves_with_path(jshapes)}
            assert _leaf_shapes(shapes) == want
            assert {l.dtype for l in jax.tree_util.tree_leaves(jshapes)} \
                == {jnp.dtype(cfg.dtype)}
            assert all(t.dtype == torch_dtype(cfg.dtype)
                       and t.device.type == "meta"
                       for t in jax.tree_util.tree_leaves(shapes))
            assert m.stacked() == jm.stacked()
            assert m.pb.tp_sync_mask() == jm.pb.tp_sync_mask()
            for p in jm.pb._meta:
                a, b = m.pb._meta[p], jm.pb._meta[p]
                assert (a.axes, a.stacked, a.tp_grad_sync, a.init,
                        a.fan_in_dim, a.scale) == (
                    b.axes, b.stacked, b.tp_grad_sync, b.init, b.fan_in_dim,
                    b.scale), (arch, p)
            assert jax.tree_util.tree_leaves(m.fsdp_mask()) == [False] * len(
                want)
            assert cfg.param_count() == jcfg.param_count()
            assert cfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("gran", ["layerwise", "entire_model"])
def test_build_plan_units_match_reference(gran):
    """Unit tables, buckets, readiness and PRNG fold tables of every
    arch's full config (meta shapes on the port's side)."""
    from repro_torch.configs import registry
    from repro_torch.core.granularity import Granularity
    from repro_torch.core.plan import build_plan
    from repro_torch.models import DistConfig, Model
    with lm_reference() as ref:
        for arch in ARCHS:
            jm = ref.model.Model(ref.registry.get_config(arch),
                                 ref.model.DistConfig())
            m = Model(registry.get_config(arch), DistConfig())
            jplan = ref.core.build_plan(jm.param_shapes(), jm.stacked(),
                                        ref.core.Granularity(gran))
            plan = build_plan(m.param_shapes(), m.stacked(),
                              Granularity(gran))
            assert plan.summary() == jplan.summary(), arch
            assert plan.unit_dims == tuple(jplan.unit_dims)
            assert plan.unit_offsets == tuple(jplan.unit_offsets)
            assert buckets(plan) == buckets(jplan)
            assert (plan.fold_base, plan.fold_inner, plan.fold_double) == (
                tuple(jplan.fold_base), tuple(jplan.fold_inner),
                tuple(jplan.fold_double))
    phi4 = Model(dataclasses.replace(registry.get_config("phi4-mini-3.8b"),
                                     n_layers=2), DistConfig())
    plan = build_plan(phi4.param_shapes(), phi4.stacked(),
                      Granularity(gran))
    # phi4-mini at full width, depth 2: embed, head, final_norm and 9
    # stacked leaves x 2 layers; every bucket fits one grouped launch
    assert plan.num_units == (21 if gran == "layerwise" else 1)
    assert plan.num_dispatches <= 32
    assert plan.total == 1_430_535_168


# ---- layers ---------------------------------------------------------------------

@pytest.mark.parametrize("theta", [1e4, 5e5, 1e6])
def test_rope_freqs_bitwise_and_rope_within_ulps(theta):
    from repro_torch.models import layers
    rng = np.random.default_rng(int(theta) % 997)
    with lm_reference() as ref:
        for half in (8, 12, 16, 24, 56, 64):
            want = np.asarray(jax.jit(
                lambda p: (theta ** (-jnp.arange(half, dtype=jnp.float32)
                                     / half)) * p)(jnp.float32(1)))
            got = layers.rope_freqs(half, theta).numpy()
            assert np.array_equal(want.view(np.uint32), got.view(np.uint32))
        for dh in (16, 32, 128):
            x = rng.standard_normal((2, 40, 3, dh)).astype(np.float32)
            pos = np.arange(7, 47)
            want = np.asarray(jax.jit(ref.layers.rope, static_argnums=2)(
                jnp.asarray(x), jnp.asarray(pos), theta))
            got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos),
                              theta).numpy()
            ulp = np.spacing(np.abs(x).max(axis=-1, keepdims=True))
            assert np.all(np.abs(got - want) <= 2 * ulp)


def test_norms_match_reference():
    from repro_torch.models import layers
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 96)).astype(np.float32) * 3
    g = rng.standard_normal(96).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    with lm_reference() as ref:
        want = np.asarray(jax.jit(ref.layers.rmsnorm)(x, g))
        got = layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(g))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        want = np.asarray(jax.jit(ref.layers.layernorm)(x, g, b))
        got = layers.layernorm(*map(torch.from_numpy, (x, g, b)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        xb, gb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
        want = _f32(jax.jit(ref.layers.rmsnorm)(xb, gb))
        got = _f32(layers.rmsnorm(_t(xb), _t(gb)))
        off = got != want
        assert off.mean() <= 0.02
        ulp = np.abs(want) * 2.0 ** -7
        assert np.all(np.abs(got - want)[off] <= ulp[off])


FLASH_CASES = [  # (Sq, Sk, causal, window, q_offset, chunk, dv)
    (21, 21, True, 0, 0, 8, 16),       # S not a multiple of the chunk
    (24, 24, True, 5, 0, 8, 16),       # sliding window, as a tensor
    (16, 16, False, 0, 0, 8, 12),      # non-causal, dv != dh (MLA)
    (9, 25, True, 0, 16, 4, 16),       # q_offset: the last 9 of 25
    (9, 25, True, 3, 16, 4, 16),       # q_offset and a window
    (12, 12, True, 0, 0, 1024, 16),    # one block
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_forward_and_backward(case):
    from repro_torch.models import flash, layers
    Sq, Sk, causal, window, q_offset, chunk, dv = case
    rng = np.random.default_rng(Sq * 31 + window)
    q, k = (rng.standard_normal((2, s, 3, 16)).astype(np.float32)
            for s in (Sq, Sk))
    v = rng.standard_normal((2, Sk, 3, dv)).astype(np.float32)
    go = rng.standard_normal((2, Sq, 3, dv)).astype(np.float32)
    with lm_reference() as ref:
        def jf(q, k, v):
            return ref.flash.flash_attention(q, k, v, jnp.float32(window),
                                             causal, q_offset, chunk)
        want, vjp = jax.vjp(jax.jit(jf), q, k, v)
        wgrads = jax.jit(vjp)(jnp.asarray(go))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    w = torch.tensor(float(window)) if window else 0
    out = flash.flash_attention(tq, tk, tv, w, causal, q_offset, chunk)
    oracle = layers.chunked_attention(
        tq.detach(), tk.detach(), tv.detach(), causal=causal, window=window,
        q_offset=q_offset, q_chunk=chunk, kv_chunk=chunk)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(go))
    for got, want_g, name in zip(grads, wgrads, "qkv"):
        _close_to_max(got, want_g, 1e-5, name)


def test_flash_attention_fully_masked_rows_are_uniform():
    """-1e30 masking: a row with no visible key (q_offset pushes it before
    every key) averages all keys instead of giving NaN."""
    from repro_torch.models import flash
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 1, 8))
                                .astype(np.float32)) for _ in range(3))
    out = flash.flash_attention(q, k, v, 0, True, -10, 4)
    assert torch.isfinite(out).all()
    assert torch.allclose(out[0, :, 0], v[0, :, 0].mean(0).expand(4, 8),
                          atol=1e-6)


def _moe_params(rng, d, E, ff, shared):
    p = {"router": rng.standard_normal((d, E)) * 0.3,
         "w_gate": rng.standard_normal((E, d, ff)) / np.sqrt(d),
         "w_in": rng.standard_normal((E, d, ff)) / np.sqrt(d),
         "w_out": rng.standard_normal((E, ff, d)) / np.sqrt(ff)}
    p["router"][:, 2] = p["router"][:, 0]     # experts 0 and 2 always tie
    if shared:
        p.update(shared_w_gate=rng.standard_normal((d, ff)) / np.sqrt(d),
                 shared_w_in=rng.standard_normal((d, ff)) / np.sqrt(d),
                 shared_w_out=rng.standard_normal((ff, d)) / np.sqrt(ff))
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("top_k,cf,shared", [(1, 1.25, True), (2, 0.5, False),
                                             (2, 1.25, False)])
def test_moe_ffn_drops_ties_and_aux(top_k, cf, shared):
    """Capacity factor 0.5 drops tokens into the dump row; experts 0 and 2
    tie on every token, so top-1 must pick the lower index and top-2 both
    (lax.top_k's order)."""
    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.dist import DistConfig
    rng = np.random.default_rng(top_k * 10 + int(cf * 4))
    T, d, E, ff = 40, 16, 4, 24
    x = rng.standard_normal((T, d)).astype(np.float32)
    p = _moe_params(rng, d, E, ff, shared)
    kw = dict(name="moe", arch_type="moe", n_layers=1, d_model=d, vocab=8,
              d_ff=ff, n_experts=E, experts_per_token=top_k,
              moe_capacity_factor=cf, moe_shared_expert=shared)
    with lm_reference() as ref:
        jcfg = ref.config.ModelConfig(**kw)

        def jf(p, x):
            out, aux = ref.moe.moe_ffn(p, x, jcfg, ref.model.DistConfig())
            return out, aux
        (wout, waux), vjp = jax.vjp(jax.jit(jf), p, x)
        go = rng.standard_normal((T, d)).astype(np.float32)
        wgp, wgx = jax.jit(vjp)((jnp.asarray(go), jnp.float32(1.0)))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_ffn(tp, tx, ModelConfig(**kw), DistConfig())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(wout),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(waux), rtol=1e-5)
    if cf < 1:
        assert moe.capacity(T, top_k, E, cf) * E < T * top_k   # drops
    names = sorted(tp)
    grads = torch.autograd.grad((out * torch.from_numpy(go)).sum() + aux,
                                [tp[k] for k in names] + [tx])
    for name, g in zip(names + ["x"], grads):
        _close_to_max(g, wgx if name == "x" else wgp[name], 1e-4, name)


# ---- the model's loss and gradients ---------------------------------------------

def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.arch_type == "vlm":
        b["patch_embeds"] = (0.02 * rng.standard_normal(
            (B, cfg.frontend_seq, cfg.d_model))).astype(np.float32)
    return b


def _variant(jcfg, variant):
    if variant == "swa":        # a window shorter than the sequence
        return dataclasses.replace(jcfg, sliding_window=8, swa_pattern=0)
    if variant == "bf16":
        return dataclasses.replace(jcfg, dtype="bfloat16")
    return jcfg


@pytest.fixture(scope="module")
def reference_losses():
    """Every LOSS_CASES reference run, jitted once for the module: (JAX
    config, params, batch, loss, gradient leaves)."""
    out = {}
    with lm_reference() as ref:
        for arch, variant in LOSS_CASES:
            jcfg = _variant(ref.registry.get_smoke(arch), variant)
            jm = ref.model.Model(jcfg, ref.model.DistConfig())
            jp = jm.init(jkey(0))
            jb = _batch(jcfg, 1)
            jl, jg = jax.jit(jax.value_and_grad(
                lambda p, b: jm.loss(p, b, jkey(1))))(jp, jb)
            out[(arch, variant)] = (
                jcfg, jax.tree_util.tree_map(np.asarray, jp), jb, float(jl),
                [np.asarray(g) for g in jax.tree_util.tree_leaves(jg)])
    return out


@pytest.mark.parametrize("arch,variant", LOSS_CASES)
def test_loss_and_gradients_match_reference(arch, variant, reference_losses):
    from repro_torch.convert import (params_from_jax, tree_leaves,
                                     tree_paths, tree_unflatten)
    from repro_torch.models import DistConfig, Model
    jcfg, jp, jb, jl, jg = reference_losses[(arch, variant)]
    cfg = _port_cfg(jcfg)
    tp = params_from_jax(jp, device="cpu")
    leaves = [l.requires_grad_(True) for l in tree_leaves(tp)]
    m = Model(cfg, DistConfig())
    loss = m.loss(tree_unflatten(tree_paths(tp), leaves),
                  {k: torch.from_numpy(v) for k, v in jb.items()}, None)
    grads = torch.autograd.grad(loss, leaves)
    bf16 = variant == "bf16"
    np.testing.assert_allclose(loss.item(), jl, rtol=1e-3 if bf16 else 1e-5)
    assert len(grads) == len(jg)
    for path, g, want in zip(tree_paths(tp), grads, jg):
        assert g.dtype == leaves[0].dtype
        _close_to_max(g, want, 5e-2 if bf16 else 1e-4, "/".join(path))


def test_loss_without_remat_is_bitwise_and_init_is_deterministic():
    """remat recomputes the same ops: gradients bitwise with and without
    it; init from one key twice gives the same params."""
    from repro_torch import random as R
    from repro_torch.configs import get_smoke
    from repro_torch.convert import tree_leaves, tree_paths, tree_unflatten
    from repro_torch.models import DistConfig, Model
    cfg = get_smoke("llama4-maverick-400b-a17b")
    m = Model(cfg, DistConfig())
    p = m.init(R.key(3), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(p), tree_leaves(m.init(R.key(3), device="cpu"))))
    assert torch.equal(p["blocks"]["a_attn_norm_g"],
                       torch.ones_like(p["blocks"]["a_attn_norm_g"]))
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2).items()}
    out = []
    for remat in (True, False):
        leaves = [l.clone().requires_grad_(True) for l in tree_leaves(p)]
        loss = m.loss(tree_unflatten(tree_paths(p), leaves), b, None,
                      remat=remat)
        out.append(torch.autograd.grad(loss, leaves))
    assert all(torch.equal(a, b) for a, b in zip(*out))


# ---- data and conversion ---------------------------------------------------

def test_make_markov_bitwise_and_lm_batches():
    from repro_torch import random as R
    from repro_torch.data import lm_batches, make_markov, patches_stub
    with lm_reference() as ref:
        for vocab, seed in ((128, 1), (512, 0)):
            want = np.asarray(ref.synthetic.make_markov(vocab, seed))
            got = make_markov(vocab, seed, device="cpu").numpy()
            assert np.array_equal(want.view(np.uint32), got.view(np.uint32))
    a, b = (next(lm_batches(128, 8, 32, seed=1, device="cpu"))
            for _ in range(2))
    assert a["tokens"].shape == a["targets"].shape == (8, 32)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < 128
    pe = patches_stub(R.key(4), 2, 8, 16, device="cpu")
    assert pe.shape == (2, 8, 16) and pe.dtype == torch.float32


def test_params_from_jax_bf16_bitwise():
    from repro_torch.convert import params_from_jax, tree_leaves
    with lm_reference() as ref:
        jcfg = dataclasses.replace(ref.registry.get_smoke("granite-20b"),
                                   dtype="bfloat16")
        jp = ref.model.Model(jcfg, ref.model.DistConfig()).init(jkey(2))
        np_tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = params_from_jax(np_tree, device="cpu")
    for want, got in zip(jax.tree_util.tree_leaves(np_tree),
                         tree_leaves(tp)):
        assert got.dtype == torch.bfloat16
        assert np.array_equal(want.view(np.uint16),
                              got.view(torch.int16).numpy().view(np.uint16))


# ---- what this slice leaves out ------------------------------------------------

def test_unported_paths_name_their_queue_item(tmp_path):
    """The sharded configs construct (tensor, FSDP and sequence
    parallelism run in tests/test_torch_tp.py and test_torch_fsdp.py, the
    serve CLI across ranks in test_torch_tp.py), the pod mesh's dp axes
    ("pod", "data") too; a reduction over both resolves to their
    flattened group where a mesh bound one (tests/test_torch_pod.py runs
    it) and is a ValueError where none is bound; an fsdp axis outside the
    dp axes is the reference's ValueError; serve's trace and metrics
    outputs (item 6, ported) write the reference's structure: one prefill
    span and gen - 1 decode spans, gen - 1 serve/decode_us samples
    (tests/test_torch_obs.py holds the rest)."""
    import json
    from repro_torch.launch import serve
    from repro_torch.obs import read_jsonl, validate_chrome_trace
    from repro_torch.models import DistConfig
    for kw in ({"tp": "model"}, {"fsdp": "data", "dp": ("data",)},
               {"sp": True}, {"fsdp": "data", "dp": ("pod", "data")}):
        assert all(getattr(DistConfig(**kw), k) == v for k, v in kw.items())
    from repro_torch.models import dist as D
    pod = {"pod": D.Axis(None, 2, 1), "data": D.Axis(None, 2, 0)}
    D.bind_axes({**pod, ("pod", "data"): D.Axis(None, 4, 2)})
    assert (D.axis_size(("pod", "data")), D.axis_index(("pod", "data")),
            D.axis_index("data")) == (4, 2, 0)
    D.bind_axes(pod)
    with pytest.raises(ValueError, match="flattened group"):
        D.axis_size(("pod", "data"))
    D.bind_axes({})
    with pytest.raises(ValueError, match="last dp axis"):
        DistConfig(fsdp="data")
    base = ["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt", "8", "--gen", "3"]
    trace, metrics = tmp_path / "t.json", tmp_path / "m.jsonl"
    for extra in (["--trace-out", str(trace)],
                  ["--metrics-out", str(metrics)]):
        assert serve.main(base + extra) == 0
    obj = json.loads(trace.read_text())
    assert validate_chrome_trace(obj)
    assert [e["name"] for e in obj["traceEvents"] if e["ph"] == "X"] == \
        ["prefill", "decode", "decode"]
    (line,) = read_jsonl(str(metrics))
    assert line["histograms"]["serve/decode_us"]["count"] == 2
    assert line["counters"] == {"serve/requests": 1.0, "serve/tokens": 4.0}


def test_model_refuses_cuda_without_a_card():
    from repro_torch import random as R
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models import DistConfig, Model
    assert not torch.cuda.is_available()
    m = Model(get_smoke("llama3-405b"), DistConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init(R.key(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init_cache(8, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3-405b", "--smoke"])
