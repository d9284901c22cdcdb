"""Model assembly: parameter declaration, the train loss, prefill and
decode of every architecture family, and the cache layouts (the JAX
package's models/model.py), on one device or on a rank of a (data, model)
mesh: the DistConfig and the axes bound in models.dist decide.

`declare_params` ports every branch, so shapes, stacked masks and
UnitPlans equal the reference's for all ten archs. `Model.loss` runs the
dense (GQA / MQA / MLA), MoE (interleaved too), VLM, SSM, hybrid and
audio families; `prefill`, `decode_step` and `init_cache` serve all of
them. Layers run in a Python loop over the stacked leaves (the reference's
lax.scan), each under torch.utils.checkpoint when `remat` and gradients
are on (the reference's jax.checkpoint with nothing saveable); the
reference's optimization barrier, a guard against XLA hoisting, has no
counterpart. Under tensor parallelism each rank holds its blocks of the
params (`param_pspecs`); sequence parallelism shards the residual stream
over the TP axis between the embedding and the final norm; FSDP leaves
are gathered per layer (`fsdp_param`), their gradients compressed by the
hook in the backward with the layer's key (`_layer_keys`).

Caches keep the reference's stacked layout (a leading layer dim, the
leaves of `cache_shapes`), so a reference cache converts leaf for leaf
(convert.cache_from_jax). `decode_step` writes the new token into that
cache IN PLACE, through per-layer views, and returns it: the reference
rebuilds the cache functionally, which here would copy it whole at every
token. Prefill and decode run under torch.inference_mode.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.utils.checkpoint as checkpoint

from repro_torch import resolve_device
from repro_torch.convert import map_tree
from repro_torch.models import blocks as B
from repro_torch.models.config import ModelConfig
from repro_torch import random as R
from repro_torch.models.dist import (DistConfig, all_gather, fdot,
                                     fsdp_param, gather_replicated,
                                     key_to_bits, make_slice_replicated,
                                     tp_region_in, vp_embed, vp_xent_chunked)
from repro_torch.models.layers import apply_norm, sinusoid_positions
from repro_torch.models.mamba2 import mamba2_block, mamba2_decode
from repro_torch.models.params import LeafMeta, ParamBuilder, torch_dtype
from repro_torch.random import fold_in


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ==========================================================================
# parameter declaration
# ==========================================================================

def _add_norm(pb: ParamBuilder, path: str, shape, cfg, stacked):
    pb.add(path + "_g", shape, (None,) * len(shape), stacked=stacked,
           init="ones")
    if cfg.norm == "layernorm":
        pb.add(path + "_b", shape, (None,) * len(shape), stacked=stacked,
               init="zeros")


def _add_attn(pb: ParamBuilder, base: str, cfg: ModelConfig, tp_size: int,
              L: Optional[int], F, prefix: str = ""):
    """GQA attention tensors. L=None -> non-stacked (shared block)."""
    d = cfg.d_model
    Hp = _ceil_to(cfg.n_heads, tp_size)
    dh = cfg.d_head
    stk = L is not None
    lead = (L,) if stk else ()
    la = (None,) if stk else ()
    _add_norm(pb, f"{base}/{prefix}attn_norm", lead + (d,), cfg, stk)
    pb.add(f"{base}/{prefix}wq", lead + (d, Hp * dh), la + (F, "tp"),
           stacked=stk, fan_in_dim=len(lead))
    pb.add(f"{base}/{prefix}wk", lead + (d, cfg.n_kv_heads * dh),
           la + (F, None), stacked=stk, tp_grad_sync=True,
           fan_in_dim=len(lead))
    pb.add(f"{base}/{prefix}wv", lead + (d, cfg.n_kv_heads * dh),
           la + (F, None), stacked=stk, tp_grad_sync=True,
           fan_in_dim=len(lead))
    pb.add(f"{base}/{prefix}wo", lead + (Hp * dh, d), la + ("tp", F),
           stacked=stk, fan_in_dim=len(lead))


def _add_mla(pb: ParamBuilder, base: str, cfg: ModelConfig, tp_size: int,
             L: int, F):
    d = cfg.d_model
    Hp = _ceil_to(cfg.n_heads, tp_size)
    qr, r = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    _add_norm(pb, f"{base}/attn_norm", (L, d), cfg, True)
    pb.add(f"{base}/wq_down", (L, d, qr), (None, F, None), stacked=True,
           tp_grad_sync=True, fan_in_dim=1)
    pb.add(f"{base}/q_norm_g", (L, qr), (None, None), stacked=True,
           init="ones")
    pb.add(f"{base}/wq_up", (L, qr, Hp * (nope + rd)), (None, None, "tp"),
           stacked=True, fan_in_dim=1)
    pb.add(f"{base}/wkv_down", (L, d, r + rd), (None, F, None), stacked=True,
           tp_grad_sync=True, fan_in_dim=1)
    pb.add(f"{base}/kv_norm_g", (L, r), (None, None), stacked=True,
           init="ones")
    pb.add(f"{base}/wk_up", (L, r, Hp * nope), (None, None, "tp"),
           stacked=True, fan_in_dim=1)
    pb.add(f"{base}/wv_up", (L, r, Hp * vd), (None, None, "tp"),
           stacked=True, fan_in_dim=1)
    pb.add(f"{base}/wo", (L, Hp * vd, d), (None, "tp", F), stacked=True,
           fan_in_dim=1)


def _add_mlp(pb: ParamBuilder, base: str, cfg: ModelConfig, L: Optional[int],
             F, names=("w_gate", "w_in", "w_out"), d_ff=None,
             prefix: str = ""):
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    stk = L is not None
    lead = (L,) if stk else ()
    la = (None,) if stk else ()
    _add_norm(pb, f"{base}/{prefix}mlp_norm", lead + (d,), cfg, stk)
    if cfg.mlp == "swiglu":
        pb.add(f"{base}/{prefix}{names[0]}", lead + (d, ff), la + (F, "tp"),
               stacked=stk, fan_in_dim=len(lead))
    pb.add(f"{base}/{prefix}{names[1]}", lead + (d, ff), la + (F, "tp"),
           stacked=stk, fan_in_dim=len(lead))
    pb.add(f"{base}/{prefix}{names[2]}", lead + (ff, d), la + ("tp", F),
           stacked=stk, fan_in_dim=len(lead))


def _add_moe(pb: ParamBuilder, base: str, cfg: ModelConfig, L: int, F,
             prefix: str = ""):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    _add_norm(pb, f"{base}/{prefix}mlp_norm", (L, d), cfg, True)
    pb.add(f"{base}/{prefix}router", (L, d, E), (None, None, None),
           stacked=True, tp_grad_sync=True, fan_in_dim=1)
    if cfg.mlp == "swiglu":
        pb.add(f"{base}/{prefix}w_gate", (L, E, d, ff), (None, "tp", F, None),
               stacked=True, fan_in_dim=2)
    pb.add(f"{base}/{prefix}w_in", (L, E, d, ff), (None, "tp", F, None),
           stacked=True, fan_in_dim=2)
    pb.add(f"{base}/{prefix}w_out", (L, E, ff, d), (None, "tp", None, F),
           stacked=True, fan_in_dim=2)
    if cfg.moe_shared_expert:
        pb.add(f"{base}/{prefix}shared_w_gate", (L, d, ff), (None, F, "tp"),
               stacked=True, fan_in_dim=1)
        pb.add(f"{base}/{prefix}shared_w_in", (L, d, ff), (None, F, "tp"),
               stacked=True, fan_in_dim=1)
        pb.add(f"{base}/{prefix}shared_w_out", (L, ff, d), (None, "tp", F),
               stacked=True, fan_in_dim=1)


def _add_ssm(pb: ParamBuilder, base: str, cfg: ModelConfig, L: int, F):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    nh = d_in // cfg.ssm_head_dim
    N, K, G = cfg.ssm_state, cfg.ssm_conv, cfg.ssm_groups
    _add_norm(pb, f"{base}/norm_in", (L, d), cfg, True)
    pb.add(f"{base}/w_z", (L, d, d_in), (None, F, "tp"), stacked=True,
           fan_in_dim=1)
    pb.add(f"{base}/w_x", (L, d, d_in), (None, F, "tp"), stacked=True,
           fan_in_dim=1)
    pb.add(f"{base}/w_bc", (L, d, 2 * G * N), (None, F, None), stacked=True,
           tp_grad_sync=True, fan_in_dim=1)
    pb.add(f"{base}/w_dt", (L, d, nh), (None, F, "tp"), stacked=True,
           fan_in_dim=1)
    pb.add(f"{base}/conv_x", (L, d_in, K), (None, "tp", None), stacked=True,
           scale=0.5, fan_in_dim=2)
    pb.add(f"{base}/conv_bc", (L, 2 * G * N, K), (None, None, None),
           stacked=True, tp_grad_sync=True, scale=0.5, fan_in_dim=2)
    pb.add(f"{base}/A_log", (L, nh), (None, "tp"), stacked=True, init="zeros")
    pb.add(f"{base}/D", (L, nh), (None, "tp"), stacked=True, init="ones")
    pb.add(f"{base}/dt_bias", (L, nh), (None, "tp"), stacked=True,
           init="zeros")
    pb.add(f"{base}/norm_g", (L, d_in), (None, "tp"), stacked=True,
           init="ones")
    pb.add(f"{base}/w_out", (L, d_in, d), (None, "tp", F), stacked=True,
           fan_in_dim=1)


def declare_params(cfg: ModelConfig, tp_size: int) -> ParamBuilder:
    pb = ParamBuilder(cfg.dtype)
    F = "fsdp" if cfg.use_fsdp else None
    d, L = cfg.d_model, cfg.n_layers
    Vp = _ceil_to(cfg.vocab, 128)

    pb.add("embed", (Vp, d), ("tp", F), fan_in_dim=1)
    if not cfg.tie_embeddings:
        pb.add("head", (d, Vp), (F, "tp"), fan_in_dim=0)
    _add_norm(pb, "final_norm", (d,), cfg, False)

    if cfg.arch_type in ("dense", "vlm", "moe"):
        if cfg.n_experts and cfg.moe_every > 1:
            # interleaved MoE (llama4): one stacked unit = dense block + MoE
            # block; params carry a_/b_ prefixes within the unit.
            if cfg.moe_every != 2 or L % 2:
                raise ValueError("interleaved MoE needs moe_every == 2 and "
                                 f"an even n_layers, got {cfg.moe_every} / "
                                 f"{L}")
            Lu = L // 2
            _add_attn(pb, "blocks", cfg, tp_size, Lu, F, prefix="a_")
            _add_mlp(pb, "blocks", cfg, Lu, F, prefix="a_")
            _add_attn(pb, "blocks", cfg, tp_size, Lu, F, prefix="b_")
            _add_moe(pb, "blocks", cfg, Lu, F, prefix="b_")
        else:
            if cfg.attention == "gqa":
                _add_attn(pb, "blocks", cfg, tp_size, L, F)
            else:
                _add_mla(pb, "blocks", cfg, tp_size, L, F)
            if cfg.n_experts:
                _add_moe(pb, "blocks", cfg, L, F)
            else:
                _add_mlp(pb, "blocks", cfg, L, F)
    elif cfg.arch_type == "ssm":
        _add_ssm(pb, "blocks", cfg, L, F)
    elif cfg.arch_type == "hybrid":
        G = L // cfg.attn_every
        tail = L - G * cfg.attn_every
        _add_ssm(pb, "blocks", cfg, G * cfg.attn_every, F)
        if tail:
            _add_ssm(pb, "tail_blocks", cfg, tail, F)
        _add_attn(pb, "shared", cfg, tp_size, None, F)
        _add_mlp(pb, "shared", cfg, None, F)
    elif cfg.arch_type == "audio":
        Le = cfg.encoder_layers
        pb.add("enc_pos", (cfg.frontend_seq, d), (None, None), scale=0.02,
               fan_in_dim=1)
        _add_attn(pb, "encoder_blocks", cfg, tp_size, Le, F)
        _add_mlp(pb, "encoder_blocks", cfg, Le, F)
        _add_norm(pb, "enc_final_norm", (d,), cfg, False)
        _add_attn(pb, "decoder_blocks", cfg, tp_size, L, F)
        _add_norm(pb, "decoder_blocks/cross_norm", (L, d), cfg, True)
        pb.add("decoder_blocks/cwq",
               (L, d, _ceil_to(cfg.n_heads, tp_size) * cfg.d_head),
               (None, F, "tp"), stacked=True, fan_in_dim=1)
        pb.add("decoder_blocks/cwk", (L, d, cfg.d_kv), (None, F, None),
               stacked=True, tp_grad_sync=True, fan_in_dim=1)
        pb.add("decoder_blocks/cwv", (L, d, cfg.d_kv), (None, F, None),
               stacked=True, tp_grad_sync=True, fan_in_dim=1)
        pb.add("decoder_blocks/cwo",
               (L, _ceil_to(cfg.n_heads, tp_size) * cfg.d_head, d),
               (None, "tp", F), stacked=True, fan_in_dim=1)
        _add_mlp(pb, "decoder_blocks", cfg, L, F)
    else:
        raise ValueError(cfg.arch_type)
    return pb


# ==========================================================================
# the Model
# ==========================================================================

def _layers(p_blocks: Dict):
    """The stacked leaves of p_blocks as one dict of views a layer."""
    names = list(p_blocks)
    return [dict(zip(names, leaves))
            for leaves in zip(*(p_blocks[k].unbind(0) for k in names))]


def _split_ab(g: Dict):
    """An interleaved unit's a_ (dense) and b_ (MoE) halves."""
    return ({k[2:]: v for k, v in g.items() if k.startswith("a_")},
            {k[2:]: v for k, v in g.items() if k.startswith("b_")})


def _stack(caches):
    """Per-layer caches -> one cache with a leading layer dim (the
    reference's scan output)."""
    return map_tree(lambda *ts: torch.stack(ts), *caches)


def _row(cache, i: int):
    """Layer i's views of a stacked cache."""
    return map_tree(lambda t: t[i], cache)


def _ssm_cache(out_state):
    (cx, cbc), ss = out_state
    return {"conv_x": cx, "conv_bc": cbc, "ssm": ss}


class Model:
    """One architecture's parameters, train loss and serving path, on one
    device or on this rank's shards of a (data, model) mesh. Params are
    nested dicts of tensors in the JAX layout (stacked leaves lead with
    the layer count), each leaf this rank's block of the global leaf under
    `param_pspecs()`, so UnitPlan ids, PRNG folds and bucket order equal
    the reference's inside shard_map."""

    def __init__(self, cfg: ModelConfig, dist: DistConfig,
                 mesh_axis_sizes: Optional[Dict[str, int]] = None):
        self.cfg = cfg
        self.dist = dist
        sizes = mesh_axis_sizes or {}
        self.sizes = dict(sizes)
        self.tp_size = sizes.get(dist.tp, 1) if dist.tp else 1
        self.dp_size = 1
        for a in dist.dp:
            self.dp_size *= sizes.get(a, 1)
        self.pb = declare_params(cfg, self.tp_size)
        self.meta = self.pb.meta()
        self.vocab_padded = _ceil_to(cfg.vocab, 128)
        self.dist_nosp = dataclasses.replace(dist, sp=False)

    def _eff(self, seq_len: int) -> DistConfig:
        """Sequence parallelism applies when enabled, tp > 1, the sequence
        divides the TP size, and the arch is not encoder-decoder."""
        if (not self.dist.sp or self.dist.tp is None or self.tp_size <= 1
                or seq_len % self.tp_size != 0
                or self.cfg.arch_type == "audio"):
            return self.dist_nosp
        return self.dist

    def _sp_slice(self, x, dist):
        if not dist.sp:
            return x
        return make_slice_replicated(self.tp_size)(x, dist.tp, 1)

    def _sp_gather(self, x, dist):
        if not dist.sp:
            return x
        return gather_replicated(x, dist.tp, 1)

    # ---- plumbing ------------------------------------------------------
    def init(self, key: torch.Tensor, device="cuda") -> Dict:
        """GLOBAL params (params.shard gives a rank its blocks)."""
        return self.pb.init(key, device=device)

    def param_shapes(self) -> Dict:
        return self.pb.shapes()

    def param_pspecs(self) -> Dict:
        return self.pb.pspecs(self.dist)

    def stacked(self) -> Dict:
        return self.pb.stacked_mask()

    def fsdp_mask(self) -> Dict:
        """True for leaves aggregated inside the backward (the FSDP hook);
        False for leaves aggregated after it (compressed_allreduce)."""
        def walk(t):
            if isinstance(t, LeafMeta):
                return t.fsdp_dim() is not None and self.dist.fsdp is not None
            return {k: walk(v) for k, v in t.items()}
        return walk(self.meta)

    def _gather_leaf(self, w, meta: LeafMeta, kb, comp, consumed_lead=1):
        fd = meta.fsdp_dim()
        if fd is not None and self.dist.fsdp is not None:
            return fsdp_param(w, kb, fd - consumed_lead, self.dist, comp)
        return w

    def _gather_layer(self, p_layer: Dict, meta_layer: Dict, kb, comp,
                      consumed_lead=1):
        return {k: self._gather_leaf(w, meta_layer[k], kb, comp,
                                     consumed_lead)
                for k, w in p_layer.items()}

    def _decode_fd(self, meta_layer: Dict, consumed_lead=1):
        """fsdp-dim map for 2D-TP decode (weights stay sharded)."""
        if self.dist.fsdp is None:
            return {}
        return {k: (None if m.fsdp_dim() is None
                    else m.fsdp_dim() - consumed_lead)
                for k, m in meta_layer.items()}

    def _layer_window(self, idx: int) -> int:
        """Layer idx's sliding window (0 = full attention): every
        swa_pattern-th layer full, the rest cfg.sliding_window."""
        cfg = self.cfg
        if cfg.swa_pattern > 0:
            return 0 if (idx + 1) % cfg.swa_pattern == 0 \
                else cfg.sliding_window
        return cfg.sliding_window

    @staticmethod
    def _layer_keys(key: torch.Tensor, L: int) -> torch.Tensor:
        """(L, 2) f32 key bits fold_in(key, i), i < L: the FSDP hook's key
        for layer i."""
        return key_to_bits(fold_in(key.cpu(), torch.arange(L)))

    # ---- embedding / head ----------------------------------------------
    def _embed(self, params, tokens, kb=None, comp=None):
        w = self._gather_leaf(params["embed"], self.meta["embed"], kb, comp,
                              consumed_lead=0)
        return vp_embed(w, tokens, self.dist.tp, self.vocab_padded)

    def _head_weight(self, params, kb=None, comp=None):
        """(d, V_local) head matrix, FSDP-gathered / the tied embedding
        transposed."""
        if self.cfg.tie_embeddings:
            w = self._gather_leaf(params["embed"], self.meta["embed"], kb,
                                  comp, consumed_lead=0)
            return w.transpose(0, 1)
        return self._gather_leaf(params["head"], self.meta["head"], kb,
                                 comp, consumed_lead=0)

    def _lm_loss(self, params, x, targets, kb, comp, eff):
        """Final norm, then the chunked fused head + vocab-parallel
        cross-entropy (the full logits never materialized), mean over the
        tokens. x arrives gathered (replicated over tp)."""
        cfg = self.cfg
        Bt, S_tot = targets.shape
        x = apply_norm(params, "final_norm", x, cfg)
        w = self._head_weight(params, kb, comp)
        xi = tp_region_in(x, eff.tp)
        s = vp_xent_chunked(xi.reshape(-1, cfg.d_model), w,
                            targets.reshape(-1), eff.tp, cfg.vocab)
        return s / (Bt * S_tot)

    def _logits(self, params, x, kb=None, comp=None):
        """(B,S,d) -> (B,S,V_local) logits of this rank's vocab shard."""
        return tp_region_in(x, self.dist.tp) @ self._head_weight(params, kb,
                                                                 comp)

    def _positions(self, x, pos0: int):
        """x + the sinusoidal positions pos0 .. pos0+S-1 (no RoPE)."""
        pos = pos0 + torch.arange(x.shape[1], device=x.device)
        return x + sinusoid_positions(pos, self.cfg.d_model).to(x.dtype)[None]

    # ---- stacks (train / prefill) ----------------------------------------
    def _run_stack(self, p_blocks, meta_blocks, x, comp, key, *,
                   block_kind: str, pos_offset=0, causal=True, memory=None,
                   collect_cache=0, remat=True, dist=None):
        """x through every stacked layer of p_blocks -> (x, aux f32, the
        stacked cache or None). block_kind "decoder" or "ssm"."""
        cfg = self.cfg
        dist = dist if dist is not None else self.dist_nosp
        if block_kind not in ("decoder", "ssm"):
            raise ValueError(block_kind)
        interleaved = (block_kind == "decoder" and cfg.n_experts
                       and cfg.moe_every > 1)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        layers = _layers(p_blocks)
        kbs = self._layer_keys(key, len(layers)).to(x.device)

        def apply(p_layer, x, kb, idx):
            g = self._gather_layer(p_layer, meta_blocks, kb, comp)
            if interleaved:
                ga, gb = _split_ab(g)
                cfg_a = dataclasses.replace(cfg, n_experts=0)
                x, aux_a, ca = B.decoder_block(
                    ga, x, cfg_a, dist, window=self._layer_window(2 * idx),
                    pos_offset=pos_offset, causal=causal,
                    use_rope=cfg.use_rope, collect_cache=collect_cache,
                    tp_size=self.tp_size)
                x, aux_b, cb = B.decoder_block(
                    gb, x, cfg, dist, window=self._layer_window(2 * idx + 1),
                    pos_offset=pos_offset, causal=causal,
                    use_rope=cfg.use_rope, collect_cache=collect_cache,
                    tp_size=self.tp_size)
                return x, aux_a + aux_b, ((ca, cb) if collect_cache
                                          else None)
            if block_kind == "decoder":
                return B.decoder_block(
                    g, x, cfg, dist, window=self._layer_window(idx),
                    pos_offset=pos_offset, causal=causal,
                    use_rope=cfg.use_rope, memory=memory,
                    collect_cache=collect_cache, tp_size=self.tp_size)
            h = apply_norm(g, "norm_in", x, cfg, dist)
            if collect_cache:
                out, state = mamba2_block(g, h, cfg, dist, return_state=True)
                return x + out, zero, _ssm_cache(state)
            return x + mamba2_block(g, h, cfg, dist), zero, None

        aux = zero
        caches = []
        for idx, p_layer in enumerate(layers):
            if remat and torch.is_grad_enabled():
                x, aux_l, cache = checkpoint.checkpoint(
                    apply, p_layer, x, kbs[idx], idx, use_reentrant=False)
            else:
                x, aux_l, cache = apply(p_layer, x, kbs[idx], idx)
            aux = aux + aux_l
            caches.append(cache)
        return x, aux, (_stack(caches) if collect_cache else None)

    # ---- hybrid (zamba2) stack ------------------------------------------
    def _run_hybrid(self, params, x, comp, key, *, collect_cache=0,
                    remat=True, dist=None):
        """Groups of attn_every Mamba2 layers, each followed by the shared
        attention block, then the tail layers -> (x, cache or None)."""
        cfg = self.cfg
        dist = dist if dist is not None else self.dist_nosp
        k_per = cfg.attn_every
        Gn = cfg.n_layers // k_per
        layers = _layers(params["blocks"])
        meta_b, shared_meta = self.meta["blocks"], self.meta["shared"]
        kbs = self._layer_keys(key, Gn).to(x.device)
        cfg_a = dataclasses.replace(cfg, n_experts=0)

        def group(x, gidx):
            kb = kbs[gidx]
            mcaches = []
            for p_layer in layers[gidx * k_per:(gidx + 1) * k_per]:
                g = self._gather_layer(p_layer, meta_b, kb, comp)
                h = apply_norm(g, "norm_in", x, cfg, dist)
                if collect_cache:
                    out, state = mamba2_block(g, h, cfg, dist,
                                              return_state=True)
                    mcaches.append(_ssm_cache(state))
                else:
                    out = mamba2_block(g, h, cfg, dist)
                x = x + out
            gs = self._gather_layer(params["shared"], shared_meta, kb, comp,
                                    consumed_lead=0)
            x, _, acache = B.decoder_block(
                gs, x, cfg_a, dist, window=cfg.sliding_window,
                causal=True, use_rope=cfg.use_rope,
                collect_cache=collect_cache, tp_size=self.tp_size)
            return x, ((_stack(mcaches), acache) if collect_cache else None)

        caches = []
        for gidx in range(Gn):
            if remat and torch.is_grad_enabled():
                x, c = checkpoint.checkpoint(group, x, gidx,
                                             use_reentrant=False)
            else:
                x, c = group(x, gidx)
            caches.append(c)
        tail = None
        if "tail_blocks" in params:
            x, _, tail = self._run_stack(
                params["tail_blocks"], self.meta["tail_blocks"], x, comp,
                fold_in(key.cpu(), 7777), block_kind="ssm",
                collect_cache=collect_cache, remat=remat, dist=dist)
        if not collect_cache:
            return x, None
        return x, {"mamba": _stack([m for m, _ in caches]),
                   "attn": _stack([a for _, a in caches]), "tail": tail}

    # ---- top-level forward: train loss ----------------------------------
    def _embed_input(self, params, batch, kb=None, comp=None):
        """Token embeddings, the VLM's patch embeddings over the first
        positions, and sinusoidal positions when the arch has no RoPE."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"], kb, comp)
        if cfg.arch_type == "vlm":
            patches = batch["patch_embeds"].to(x.dtype)
            x = torch.cat([patches, x[:, patches.shape[1]:]], dim=1)
        if not cfg.use_rope:
            x = self._positions(x, 0)
        return x

    def loss(self, params, batch, key=None, comp=None, remat: bool = True):
        """Mean next-token cross-entropy + 0.01 x the MoE aux loss. `key`
        (default key(0)) and `comp` drive the FSDP gradient hook: Q_W of
        comp runs on each FSDP leaf's local gradient in the backward."""
        cfg = self.cfg
        key = R.key(0) if key is None else key
        kb = key_to_bits(key.cpu())
        if cfg.arch_type == "audio":
            return self._loss_audio(params, batch, key, comp, remat)
        eff = self._eff(batch["tokens"].shape[1])
        x = self._sp_slice(self._embed_input(params, batch, kb, comp), eff)
        if cfg.arch_type in ("dense", "moe", "vlm"):
            x, aux, _ = self._run_stack(params["blocks"], self.meta["blocks"],
                                        x, comp, key, block_kind="decoder",
                                        remat=remat, dist=eff)
        elif cfg.arch_type == "ssm":
            x, aux, _ = self._run_stack(params["blocks"], self.meta["blocks"],
                                        x, comp, key, block_kind="ssm",
                                        remat=remat, dist=eff)
        elif cfg.arch_type == "hybrid":
            x, _ = self._run_hybrid(params, x, comp, key, remat=remat,
                                    dist=eff)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            raise ValueError(cfg.arch_type)
        x = self._sp_gather(x, eff)
        return self._lm_loss(params, x, batch["targets"], kb, comp,
                             eff) + 0.01 * aux

    def _loss_audio(self, params, batch, key, comp, remat):
        kb = key_to_bits(key.cpu())
        mem = self._encode_audio(params, batch["frames"], comp, key, remat)
        x = self._positions(self._embed(params, batch["tokens"], kb, comp), 0)
        x, _, _ = self._run_stack(params["decoder_blocks"],
                                  self.meta["decoder_blocks"], x, comp, key,
                                  block_kind="decoder", memory=mem,
                                  remat=remat)
        return self._lm_loss(params, x, batch["targets"], kb, comp,
                             self.dist_nosp)

    def _encode_audio(self, params, frames, comp, key, remat):
        """The encoder over the frame embeddings (non-causal) -> memory."""
        cfg = self.cfg
        x = frames.to(torch_dtype(cfg.dtype)) + params["enc_pos"][None]
        x, _, _ = self._run_stack(params["encoder_blocks"],
                                  self.meta["encoder_blocks"], x, comp,
                                  fold_in(key.cpu(), 99),
                                  block_kind="decoder", causal=False,
                                  remat=remat)
        return apply_norm(params, "enc_final_norm", x, cfg)

    # ---- prefill ---------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, params, batch, key=None, remat: bool = True,
                cache_len: int = None):
        """Forward over the prompt -> (last position's logits (B,V_local),
        this rank's cache shard). cache_len: the cache's capacity (>= the
        prompt, so generated tokens have slots); defaults to the prompt
        length. `key` and `remat` are the reference's (no gradient runs
        here)."""
        cfg = self.cfg
        key = R.key(0) if key is None else key
        kb = key_to_bits(key.cpu())
        S = batch["tokens"].shape[1]
        clen = self.cache_len(cache_len or S)
        if cfg.arch_type == "audio":
            mem = self._encode_audio(params, batch["frames"], None, key,
                                     remat)
            x = self._positions(self._embed(params, batch["tokens"], kb), 0)
            x, _, caches = self._run_stack(
                params["decoder_blocks"], self.meta["decoder_blocks"], x,
                None, key, block_kind="decoder", memory=mem,
                collect_cache=clen)
            caches = {"self": caches, "memory": mem}
        else:
            eff = self._eff(S)
            x = self._sp_slice(self._embed_input(params, batch, kb), eff)
            if cfg.arch_type in ("dense", "moe", "vlm"):
                x, _, caches = self._run_stack(
                    params["blocks"], self.meta["blocks"], x, None, key,
                    block_kind="decoder", collect_cache=clen, dist=eff)
            elif cfg.arch_type == "ssm":
                x, _, caches = self._run_stack(
                    params["blocks"], self.meta["blocks"], x, None, key,
                    block_kind="ssm", collect_cache=clen, dist=eff)
            elif cfg.arch_type == "hybrid":
                x, caches = self._run_hybrid(params, x, None, key,
                                             collect_cache=clen, dist=eff)
            else:
                raise ValueError(cfg.arch_type)
            x = self._sp_gather(x, eff)
        x = apply_norm(params, "final_norm", x[:, -1:], cfg)
        return self._logits(params, x, kb)[:, 0], caches

    # ---- decode ----------------------------------------------------------
    @torch.inference_mode()
    def decode_step(self, params, token: torch.Tensor, pos, cache,
                    memory: Optional[torch.Tensor] = None):
        """token (B,) int; pos the position of token, a Python int or a
        0-d tensor (read once; on the card that waits for it, so a serving
        loop advances a host int). Writes the token into this rank's cache
        shard in place -> (logits (B,V_local), cache). FSDP weights stay
        sharded (2D tensor parallel: models.dist.fdot)."""
        cfg, dist = self.cfg, self.dist_nosp
        pos = int(pos)
        kb0 = torch.zeros((2,), dtype=torch.float32)
        x = self._embed_decode(params, token[:, None])
        if not cfg.use_rope:
            x = self._positions(x, pos)

        if cfg.arch_type in ("dense", "moe", "vlm", "audio"):
            audio = cfg.arch_type == "audio"
            bname = "decoder_blocks" if audio else "blocks"
            p_blocks = params[bname]
            fd = self._decode_fd(self.meta[bname])
            mem = cache["memory"] if audio else memory
            layer_caches = cache["self"] if audio else cache
            interleaved = cfg.n_experts and cfg.moe_every > 1
            cfg_a = dataclasses.replace(cfg, n_experts=0)
            for idx, g in enumerate(_layers(p_blocks)):
                c = _row(layer_caches, idx)
                if interleaved:
                    ga, gb = _split_ab(g)
                    fda, fdb = _split_ab(fd)
                    x, _ = B.decoder_block_decode(
                        ga, x, c[0], pos, cfg_a, dist,
                        window=self._layer_window(2 * idx), fd=fda)
                    x, _ = B.decoder_block_decode(
                        gb, x, c[1], pos, cfg, dist,
                        window=self._layer_window(2 * idx + 1), fd=fdb)
                else:
                    x, _ = B.decoder_block_decode(
                        g, x, c, pos, cfg, dist,
                        window=self._layer_window(idx), memory=mem, fd=fd)
        elif cfg.arch_type == "ssm":
            x = self._decode_ssm(params["blocks"], self.meta["blocks"], x,
                                 cache, kb0)
        elif cfg.arch_type == "hybrid":
            x = self._decode_hybrid(params, x, pos, cache, kb0)
        else:
            raise ValueError(cfg.arch_type)
        x = apply_norm(params, "final_norm", x, cfg)
        return self._logits_decode(params, x)[:, 0], cache

    def _embed_decode(self, params, tokens):
        """Vocab-parallel lookup with the d dim left fsdp-sharded, then the
        (tiny) embedding features all-gathered (2D-TP decode)."""
        x = vp_embed(params["embed"], tokens, self.dist.tp,
                     self.vocab_padded)
        if self.dist.fsdp is not None and \
                self.meta["embed"].fsdp_dim() is not None:
            x = all_gather(x, self.dist.fsdp, gather_axis=x.dim() - 1)
        return x

    def _logits_decode(self, params, x):
        xi = tp_region_in(x, self.dist.tp)
        fs = self.dist.fsdp is not None
        if self.cfg.tie_embeddings:
            fdim = self.meta["embed"].fsdp_dim()
            return fdot(xi, params["embed"].transpose(0, 1),
                        0 if (fdim is not None and fs) else None, self.dist)
        fdim = self.meta["head"].fsdp_dim()
        return fdot(xi, params["head"], 0 if (fdim is not None and fs)
                    else None, self.dist)

    def _decode_ssm(self, p_blocks, meta_b, x, cache, kb):
        """One token through stacked Mamba2 layers, states in place."""
        cfg, dist = self.cfg, self.dist_nosp
        for idx, p_layer in enumerate(_layers(p_blocks)):
            g = self._gather_layer(p_layer, meta_b, kb, None)
            c = _row(cache, idx)
            h = apply_norm(g, "norm_in", x, cfg)
            out, _ = mamba2_decode(g, h, (c["conv_x"], c["conv_bc"]),
                                   c["ssm"], cfg, dist)
            x = x + out
        return x

    def _decode_hybrid(self, params, x, pos, cache, kb):
        cfg, dist = self.cfg, self.dist_nosp
        k_per = cfg.attn_every
        Gn = cfg.n_layers // k_per
        cfg_a = dataclasses.replace(cfg, n_experts=0)
        layers = _layers(params["blocks"])
        meta_b = self.meta["blocks"]
        for gidx in range(Gn):
            mc = _row(cache["mamba"], gidx)
            for j, p_layer in enumerate(
                    layers[gidx * k_per:(gidx + 1) * k_per]):
                g = self._gather_layer(p_layer, meta_b, kb, None)
                c = _row(mc, j)
                h = apply_norm(g, "norm_in", x, cfg)
                out, _ = mamba2_decode(g, h, (c["conv_x"], c["conv_bc"]),
                                       c["ssm"], cfg, dist)
                x = x + out
            gs = self._gather_layer(params["shared"], self.meta["shared"],
                                    kb, None, consumed_lead=0)
            x, _ = B.decoder_block_decode(
                gs, x, _row(cache["attn"], gidx), pos, cfg_a,
                dist, window=cfg.sliding_window)
        if cache.get("tail") is not None:
            x = self._decode_ssm(params["tail_blocks"],
                                 self.meta["tail_blocks"], x, cache["tail"],
                                 kb)
        return x

    # ---- cache layouts ----------------------------------------------------
    def cache_len(self, seq_len: int) -> int:
        """Slots a layer's cache holds: a pure sliding-window arch keeps a
        ring of at most its window."""
        cfg = self.cfg
        if cfg.sliding_window > 0 and cfg.swa_pattern == 0:
            return min(seq_len, cfg.sliding_window)
        return seq_len

    def _attn_cache_sds(self, L, batch, clen, dtype):
        cfg = self.cfg

        def sd(shape, dt):
            return torch.empty(shape, dtype=dt, device="meta")
        if cfg.attention == "mla":
            return {"ckv": sd((L, batch, 1, clen, cfg.kv_lora_rank), dtype),
                    "krope": sd((L, batch, 1, clen, cfg.qk_rope_dim), dtype),
                    "slot_pos": sd((L, clen), torch.int32)}
        int8 = cfg.kv_cache_dtype == "int8"
        kdt = torch.int8 if int8 else dtype
        kv = (L, batch, cfg.n_kv_heads, clen, cfg.d_head)
        out = {"k": sd(kv, kdt), "v": sd(kv, kdt),
               "slot_pos": sd((L, clen), torch.int32)}
        if int8:
            out["k_scale"] = sd(kv[:-1], torch.float32)
            out["v_scale"] = sd(kv[:-1], torch.float32)
        return out

    def _ssm_cache_sds(self, lead, batch, dtype):
        cfg = self.cfg
        d_in = cfg.ssm_expand * cfg.d_model
        nh = d_in // cfg.ssm_head_dim
        N, K, G = cfg.ssm_state, cfg.ssm_conv, cfg.ssm_groups

        def sd(shape, dt):
            return torch.empty(lead + shape, dtype=dt, device="meta")
        return {"conv_x": sd((batch, K - 1, d_in), dtype),
                "conv_bc": sd((batch, K - 1, 2 * G * N), dtype),
                "ssm": sd((batch, nh, cfg.ssm_head_dim, N), torch.float32)}

    def _attn_cache_pspec(self, shard_batch: bool = True):
        dp = (tuple(self.dist.dp) or None) if shard_batch else None
        tp = self.dist.tp
        base = {"slot_pos": (None, tp)}
        if self.cfg.attention == "mla":
            base.update(ckv=(None, dp, None, tp, None),
                        krope=(None, dp, None, tp, None))
        else:
            base.update(k=(None, dp, None, tp, None),
                        v=(None, dp, None, tp, None))
            if self.cfg.kv_cache_dtype == "int8":
                base.update(k_scale=(None, dp, None, tp),
                            v_scale=(None, dp, None, tp))
        return base

    def _ssm_cache_pspec(self, shard_batch: bool = True):
        dp = (tuple(self.dist.dp) or None) if shard_batch else None
        tp = self.dist.tp
        return {"conv_x": (None, dp, None, tp),
                "conv_bc": (None, dp, None, None),
                "ssm": (None, dp, tp, None, None)}

    def cache_pspecs(self, shard_batch: bool = True):
        """The cache's partition, one entry per dim (a mesh axis name, a
        tuple of them, or None; the reference's PartitionSpecs as tuples):
        attention caches shard their slot dim over tp and their batch over
        the dp axes; shard_batch=False (a global batch smaller than the dp
        size) replicates over dp instead."""
        cfg = self.cfg
        dp = (tuple(self.dist.dp) or None) if shard_batch else None
        sb = shard_batch
        if cfg.arch_type in ("dense", "moe", "vlm"):
            if cfg.n_experts and cfg.moe_every > 1:
                return (self._attn_cache_pspec(sb), self._attn_cache_pspec(sb))
            return self._attn_cache_pspec(sb)
        if cfg.arch_type == "ssm":
            return self._ssm_cache_pspec(sb)
        if cfg.arch_type == "hybrid":
            m = {k: (None,) + v for k, v in self._ssm_cache_pspec(sb).items()}
            tail = (self._ssm_cache_pspec(sb)
                    if cfg.n_layers % cfg.attn_every else None)
            return {"mamba": m, "attn": self._attn_cache_pspec(sb),
                    "tail": tail}
        if cfg.arch_type == "audio":
            return {"self": self._attn_cache_pspec(sb),
                    "memory": (dp, None, None)}
        raise ValueError(cfg.arch_type)

    def cache_shapes(self, seq_len: int, batch: int):
        """The cache's tree as meta tensors (the reference's
        ShapeDtypeStructs): shapes and dtypes, no storage."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        clen = self.cache_len(seq_len)
        L = cfg.n_layers
        if cfg.arch_type in ("dense", "moe", "vlm"):
            if cfg.n_experts and cfg.moe_every > 1:
                return (self._attn_cache_sds(L // 2, batch, clen, dtype),
                        self._attn_cache_sds(L // 2, batch, clen, dtype))
            return self._attn_cache_sds(L, batch, clen, dtype)
        if cfg.arch_type == "ssm":
            return self._ssm_cache_sds((L,), batch, dtype)
        if cfg.arch_type == "hybrid":
            Gn = L // cfg.attn_every
            tail = L - Gn * cfg.attn_every
            return {"mamba": self._ssm_cache_sds((Gn, cfg.attn_every), batch,
                                                 dtype),
                    "attn": self._attn_cache_sds(Gn, batch, clen, dtype),
                    "tail": (self._ssm_cache_sds((tail,), batch, dtype)
                             if tail else None)}
        if cfg.arch_type == "audio":
            return {"self": self._attn_cache_sds(L, batch, clen, dtype),
                    "memory": torch.empty((batch, cfg.frontend_seq,
                                           cfg.d_model), dtype=dtype,
                                          device="meta")}
        raise ValueError(cfg.arch_type)

    def init_cache(self, seq_len: int, batch: int, device="cuda"):
        """An empty cache on `device`: zeros, slot_pos = -1 (slot_pos are
        a cache's only int32 leaves)."""
        dev = resolve_device(device)
        return map_tree(lambda s: torch.full(
            s.shape, -1 if s.dtype == torch.int32 else 0, dtype=s.dtype,
            device=dev), self.cache_shapes(seq_len, batch))
