"""Algorithm 1 on the port's LMs (experiment.lm_train_step / train_lm, the
repo's examples/quickstart.py) against quickstart's jitted step, and what
the full-width run on the card needs, in what the CPU can hold:

  - 3 steps of lm_train_step on quickstart's CFG (JAX params converted,
    JAX batches fed) against quickstart's jitted step for QSGD(16) and
    top-k(10%) at both granularities: the loss after every step within
    1e-4 relative (ROADMAP Queue 3 item 11: gradients differ by ulps, so a
    few QSGD codes or top-k selections near a boundary move);
  - in the port, the wire path (real packed payloads) bitwise the sim
    path over those steps;
  - train_lm end to end on the CPU (plain versions, no launches);
  - the top-k sort in row chunks equals one sort;
  - the 32-bit index arithmetic of the kernels a full-width phi4-mini step
    launches (the QSGD pack and unpack, the field pack and unpack) and
    the int tables that feed them, at d = 614,596,608 (the embedding and
    head units) and 1,430,535,168 (the entire model) with n = 4 workers,
    by arithmetic alone.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_ref import jkey, reference

WORKERS, LR = 4, 0.3
QUICKSTART = dict(name="quickstart-lm", arch_type="dense", n_layers=2,
                  d_model=64, vocab=128, n_heads=4, n_kv_heads=2, d_head=16,
                  d_ff=128, dtype="float32")
COMPS = [("qsgd", {"levels": 16}), ("topk", {"ratio": 0.1})]
INT32_MAX = 2**31 - 1
PHI4_EMBED = 200_064 * 3_072
PHI4_TOTAL = 1_430_535_168


def _quickstart_step(ref, jm, comp):
    """examples/quickstart.py:30-42, jitted as there."""
    stacked = jm.stacked()

    @jax.jit
    def step(params, batch, key):
        wb = jax.tree_util.tree_map(
            lambda x: x.reshape((WORKERS, -1) + x.shape[1:]), batch)
        wgrads = jax.vmap(lambda b: jax.grad(
            lambda p: jm.loss(p, b, key))(params))(wb)
        g, _ = ref.core.aggregate_simulated_workers(wgrads, stacked, comp,
                                                    key)
        return jax.tree_util.tree_map(lambda p, gg: p - LR * gg, params, g)
    return step


@pytest.fixture(scope="module")
def quickstart_runs():
    """For each (compressor, granularity): the JAX batches, the initial
    params and the loss after each of 3 quickstart steps."""
    out = {}
    with reference("repro.models.model") as ref:
        jm = ref.model.Model(ref.model.ModelConfig(**QUICKSTART),
                             ref.model.DistConfig())
        p0 = jm.init(jkey(0))
        data = ref.synthetic.lm_batches(QUICKSTART["vocab"], 8, 32, seed=1)
        batches = [next(data) for _ in range(4)]
        for name, kw in COMPS:
            for gran in ("layerwise", "entire_model"):
                comp = ref.core.CompressionConfig(
                    qw=ref.core.make_compressor(name, **kw),
                    qm=ref.core.make_compressor("identity"),
                    granularity=ref.core.Granularity(gran))
                step = _quickstart_step(ref, jm, comp)
                p, losses = p0, []
                for i in range(3):
                    p = step(p, batches[i],
                             jax.random.fold_in(jax.random.key(2), i))
                    losses.append(float(jm.loss(p, batches[3],
                                                jax.random.key(9))))
                out[(name, gran)] = losses
        np_p0 = jax.tree_util.tree_map(np.asarray, p0)
        np_batches = [jax.tree_util.tree_map(np.asarray, b) for b in batches]
    return np_p0, np_batches, out


@pytest.mark.parametrize("gran", ["layerwise", "entire_model"])
@pytest.mark.parametrize("name,kw", COMPS)
def test_lm_train_step_matches_quickstart_and_wire_is_sim(name, kw, gran,
                                                          quickstart_runs):
    from repro_torch import kernels
    from repro_torch import random as R
    from repro_torch.convert import params_from_jax, tree_leaves
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.granularity import Granularity
    from repro_torch.experiment import lm_train_step
    from repro_torch.models import DistConfig, Model, ModelConfig
    p0, batches, want = quickstart_runs
    m = Model(ModelConfig(**QUICKSTART), DistConfig())
    comp = CompressionConfig(qw=make_compressor(name, **kw),
                             granularity=Granularity(gran))
    tb = [{k: torch.from_numpy(np.array(v)) for k, v in b.items()}
          for b in batches]
    kernels.reset_launch_counts()
    for wire in (True, False):
        p = params_from_jax(p0, device="cpu")
        got = []
        for i in range(3):
            p, _ = lm_train_step(m, comp, p, tb[i], R.fold_in(R.key(2), i),
                                 LR, workers=WORKERS, wire=wire)
            with torch.no_grad():
                got.append(m.loss(p, tb[3], None).item())
        np.testing.assert_allclose(got, want[(name, gran)], rtol=1e-4)
        if wire:
            wire_params = tree_leaves(p)
    assert all(torch.equal(a, b) for a, b in zip(wire_params,
                                                 tree_leaves(p)))
    assert set(kernels.launch_counts().values()) == {0}


def test_train_lm_runs_on_the_cpu():
    from repro_torch import kernels
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.granularity import Granularity
    from repro_torch.experiment import train_lm
    from repro_torch.models import ModelConfig
    kernels.reset_launch_counts()
    cfg = ModelConfig(**QUICKSTART)
    comp = CompressionConfig(qw=make_compressor("qsgd", levels=16),
                             granularity=Granularity("layerwise"))
    first, last, secs, params = train_lm(cfg, comp, steps=6, device="cpu")
    assert np.isfinite(first) and np.isfinite(last) and last < first
    assert secs > 0 and params["embed"].shape == (128, 64)
    assert set(kernels.launch_counts().values()) == {0}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm(cfg, comp, steps=1)
    # a batch stream of the caller's (the full-width runs' uniform tokens)
    g = torch.Generator().manual_seed(0)
    seqs = [torch.randint(0, 128, (8, 33), generator=g) for _ in range(2)]
    data = iter({"tokens": s[:, :-1], "targets": s[:, 1:]} for s in seqs)
    first, last, _, _ = train_lm(cfg, comp, steps=2, device="cpu",
                                 data=data)
    assert np.isfinite(first) and np.isfinite(last)
    with pytest.raises(StopIteration):
        next(data)


def test_top_k_sort_in_row_chunks_equals_one_sort(monkeypatch):
    from repro_torch.core import compressors as C
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((7, 300)).astype(np.float32))
    x[:, ::5] = 0.5          # ties at the selection boundary
    topk = C.TopK(ratio=0.3)
    whole = topk.encode(x, None)
    monkeypatch.setattr(C, "SORT_ELEMS", 600)        # chunks of 2 rows
    assert len(C._row_chunks(x)) == 4
    chunked = topk.encode(x, None)
    assert torch.equal(whole["idx"], chunked["idx"])
    assert torch.equal(whole["val"], chunked["val"])
    monkeypatch.setattr(C, "SORT_ELEMS", 1)          # a row at a time
    assert torch.equal(C._top_idx(x, 90), torch.sort(
        x, dim=1, descending=True, stable=True)[1][:, :90])


# ---- the kernels' 32-bit arithmetic at full width ------------------------------

def _pack_extremes(n, d, width):
    """The largest value of each int expression of csrc/hash_pack.cuh's
    tile walk (the QSGD pack) over a bucket of n units of d: the last
    tile of the last unit, its last thread (the unit offsets are 64-bit)."""
    from repro_torch.kernels.qsgd import TILE_PAIRS, pack_tiles
    from repro_torch.kernels.ref import words_per_unit
    tiles = pack_tiles(d)
    h = (d + 1) // 2
    j0 = (tiles - 1) * TILE_PAIRS
    q0 = (j0 + h + 31) // 32
    return {"blocks": n * tiles, "unit * tiles": (n - 1) * tiles,
            "d + 1": d + 1, "j0 + 512 (hashed pairs)": j0 + 512,
            "j + h (j < h)": 2 * h - 1, "32 * qm + lane": 32 * (h // 32) + 31,
            "ql0 + 15": (tiles - 1) * 15 + 15, "j0 + h + 31": j0 + h + 31,
            "d + 31": d + 31, "q0 * width + nu": (q0 + 15) * width,
            "32 * q - h - j0 + 512": 32 * (q0 + 15) - h - j0 + 512,
            "wpu": words_per_unit(d, width)}


def _unpack_extremes(n, d, width):
    """csrc/unpack_tile.cuh's int expressions (the QSGD unpack's walk)."""
    from repro_torch.kernels.qsgd import TILE_CODES, unpack_tiles
    from repro_torch.kernels.ref import words_per_unit
    tiles = unpack_tiles(d)
    tw = 64 * width
    return {"blocks": n * tiles, "unit * tiles": (n - 1) * tiles,
            "w0 + tw": (tiles - 1) * tw + tw,
            "f0 + 2048": (tiles - 1) * TILE_CODES + TILE_CODES,
            "staged bit (p * width)": TILE_CODES * width,
            "wpu": words_per_unit(d, width)}


def _fields_extremes(n, k, width):
    """csrc/pack.cu's int expressions (the field pack and unpack)."""
    from repro_torch.kernels.pack import TILE_FIELDS, field_tiles
    from repro_torch.kernels.ref import words_per_unit
    tiles = field_tiles(k)
    return {"blocks": n * tiles, "unit * tiles": (n - 1) * tiles,
            "w0 + 64 * width": (tiles - 1) * 64 * width + 64 * width,
            "f0 + 2048": (tiles - 1) * TILE_FIELDS + TILE_FIELDS,
            "wpu": words_per_unit(k, width)}


def _phi4_full_width_buckets(gran):
    from repro_torch.configs import get_config
    from repro_torch.core.granularity import Granularity
    from repro_torch.core.plan import build_plan
    from repro_torch.models import DistConfig, Model
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b"), n_layers=2)
    m = Model(cfg, DistConfig())
    plan = build_plan(m.param_shapes(), m.stacked(), Granularity(gran))
    return [(WORKERS * b.n, b.dim) for b in plan.buckets]


@pytest.mark.parametrize("gran", ["layerwise", "entire_model"])
def test_kernel_int32_arithmetic_at_phi4_full_width(gran):
    """Every int the four kernels of a full-width step compute, and every
    entry of the c_int tables kernels/qsgd.py grouped_table and
    kernels/pack.py field_table hand them, fits int32 for QSGD(16) (6-bit
    codes) and the top-k(1%) index legs (30 and 31 bits), and also at the
    widest codes the kernels take (16 packed, 31 unpacked)."""
    from repro_torch.core.compressors import QSGD, _k_of, index_bits
    from repro_torch.kernels.pack import field_table
    from repro_torch.kernels.qsgd import bucket_table, unpack_table
    shapes = _phi4_full_width_buckets(gran)
    dims = sorted({d for _, d in shapes})
    assert max(dims) == (PHI4_EMBED if gran == "layerwise" else PHI4_TOTAL)
    width = QSGD(levels=16).entry_bits
    assert width == 6
    legs = [(n, _k_of(0.01, d), index_bits(d)) for n, d in shapes]
    assert index_bits(PHI4_EMBED) == 30 and index_bits(PHI4_TOTAL) == 31
    checks = {}
    for n, d in shapes:
        for w in (width, 16):
            checks[("pack", n, d, w)] = _pack_extremes(n, d, w)
        for w in (width, 31):
            checks[("unpack", n, d, w)] = _unpack_extremes(n, d, w)
        checks[("fields natural", n, d, 9)] = _fields_extremes(n, d, 9)
    for n, k, w in legs:
        checks[("fields index", n, k, w)] = _fields_extremes(n, k, w)
    for what, vals in checks.items():
        for expr, v in vals.items():
            assert 0 <= v <= INT32_MAX, (what, expr, v)
    tables = (bucket_table(shapes, width) + unpack_table(shapes, width)
              + unpack_table(shapes, 31) + field_table(legs))
    assert len(bucket_table(shapes, width)) == 1       # one launch a step
    for t in tables:
        for field in dataclasses.fields(t):
            v = getattr(t, field.name)
            assert max(v if isinstance(v, tuple) else (v,)) <= INT32_MAX, (
                field.name, v)


@pytest.mark.parametrize("d", [1, 33, 70, 1000, 4099])
def test_qsgd_pack_plain_spans_tile_the_unit(d):
    """chip_smoke evaluates the plain QSGD pack of a full-width unit in
    spans of positions: the spans' words concatenate to the whole unit's."""
    from repro_torch.kernels.qsgd import qsgd_pack_plain
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((3, d)).astype(np.float32))
    k = torch.from_numpy(rng.integers(-2**31, 2**31, (2, 3)).astype(np.int32))
    nrm = torch.linalg.vector_norm(x, dim=1) + 1e-12
    whole = qsgd_pack_plain(x, k[0], k[1], nrm, 16, 6)
    for step in (32, 64, 992):
        parts = [qsgd_pack_plain(x, k[0], k[1], nrm, 16, 6, lo,
                                 min(lo + step, d))
                 for lo in range(0, d, step)]
        assert torch.equal(torch.cat(parts, dim=1), whole)
    with pytest.raises(ValueError, match="span"):
        qsgd_pack_plain(x, k[0], k[1], nrm, 16, 6, 16, d)
