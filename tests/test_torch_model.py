"""The port's CNN and train step against the reference on a narrow resnet9
(widths (4, 8, 8)): JAX params converted with params_from_jax, JAX-made
batches fed to both sides.

Tolerances: convolutions sum in another order in torch than in XLA, so
logits, loss and gradients agree to rtol=1e-4, atol=1e-5. Over three
Algorithm-1 steps the dense loss agrees to 1e-4 relative; with a
compressor, gradient ulps move a few codes or selections (a unit's
statistic, |x| near a rounding threshold, a sign near zero, a near-tie at
the top-k boundary), so those losses agree to 1e-2 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ref import jkey, reference

WIDTHS = (4, 8, 8)
WORKERS = 4


def _cfgs(ref, kind="resnet9"):
    from repro_torch.configs.resnet9_cifar import CNNConfig
    jcfg = ref.resnet9_cifar.CNNConfig(name="narrow", widths=WIDTHS,
                                       kind=kind)
    return jcfg, CNNConfig(name="narrow", widths=WIDTHS, kind=kind)


def _batch_pair(ref, seed, n):
    b = ref.synthetic.classification_batch(jkey(seed), n)
    return b, {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _params_pair(ref, jcfg, seed=0):
    from repro_torch.convert import params_from_jax
    jp = ref.cnn.init_cnn(jcfg, jkey(seed))
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


@pytest.mark.parametrize("kind", ["resnet9", "alexnet", "mlp"])
def test_forward_loss_and_grads(kind):
    from repro_torch.convert import tree_leaves
    from repro_torch.models import cnn
    with reference() as ref:
        jcfg, cfg = _cfgs(ref, kind)
        jp, tp = _params_pair(ref, jcfg)
        jb, tb = _batch_pair(ref, 1, 8)
        jlogits = jax.jit(lambda p, x: ref.cnn.cnn_forward(jcfg, p, x))
        np.testing.assert_allclose(
            cnn.cnn_forward(cfg, tp, tb["images"]).detach().numpy(),
            np.asarray(jlogits(jp, jb["images"])), rtol=1e-4, atol=1e-5)
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p, b: ref.cnn.cnn_loss(jcfg, p, b)))(jp, jb)
        p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        loss = cnn.cnn_loss(cfg, p, tb)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
        for a, b in zip(jax.tree_util.tree_leaves(jg), grads):
            assert a.shape == tuple(b.shape)
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                       atol=1e-5)
        assert float(cnn.cnn_accuracy(cfg, tp, tb)) == float(
            ref.cnn.cnn_accuracy(jcfg, jp, jb))


def test_piecewise_linear_matches_reference():
    from repro_torch.optim.schedules import piecewise_linear
    with reference():
        from repro.optim.schedules import piecewise_linear as jpl
        for peak, total, warm in ((0.01, 120, 15), (0.4, 7, 1)):
            a, b = piecewise_linear(peak, total, warm), jpl(peak, total, warm)
            for i in range(total + 2):
                assert np.float32(a(i).item()) == np.asarray(b(i)), (peak, i)


def _jax_step(ref, jcfg, comp):
    """benchmarks/common.py's train_cnn step, jitted as it is there."""
    def momentum_step(params, vel, g, lr, momentum=0.9):
        vel = jax.tree_util.tree_map(lambda v, gg: momentum * v + gg, vel, g)
        params = jax.tree_util.tree_map(lambda p, u: p - lr * u, params, vel)
        return params, vel

    def step(params, vel, batch, key, lr):
        wb = jax.tree_util.tree_map(
            lambda x: x.reshape((WORKERS, -1) + x.shape[1:]), batch)
        wg = jax.vmap(lambda b: jax.grad(
            lambda p: ref.cnn.cnn_loss(jcfg, p, b))(params))(wb)
        if comp is None:
            g = jax.tree_util.tree_map(lambda x: jnp.mean(x, 0), wg)
        else:
            g, _ = ref.core.aggregate_simulated_workers(
                wg, ref.core.stacked_mask(params), comp, key)
        return momentum_step(params, vel, g, lr)
    return jax.jit(step)


@pytest.mark.parametrize("comp,gran,rtol", [
    (None, None, 1e-4),
    ("terngrad", "layerwise", 1e-2), ("terngrad", "entire_model", 1e-2),
    ("qsgd", "layerwise", 1e-2), ("qsgd", "entire_model", 1e-2),
    ("signsgd", "layerwise", 1e-2), ("natural", "layerwise", 1e-2),
    ("topk", "layerwise", 1e-2), ("topk", "entire_model", 1e-2),
    ("randomk", "layerwise", 1e-2), ("threshold_v", "layerwise", 1e-2),
    ("adaptive_threshold", "layerwise", 1e-2)])
def test_three_train_steps(comp, gran, rtol):
    from repro_torch import random as R
    from repro_torch.convert import tree_map
    from repro_torch.core.aggregation import CompressionConfig
    from repro_torch.core.compressors import make_compressor
    from repro_torch.core.granularity import Granularity
    from repro_torch.experiment import train_step
    from repro_torch.models import cnn
    from repro_torch.optim.schedules import piecewise_linear
    with reference() as ref:
        jcfg, cfg = _cfgs(ref)
        jp, tp = _params_pair(ref, jcfg, seed=2)
        jv = jax.tree_util.tree_map(jnp.zeros_like, jp)
        tv = tree_map(torch.zeros_like, tp)
        mine = theirs = None
        if comp is not None:
            mine = CompressionConfig(qw=make_compressor(comp),
                                     granularity=Granularity(gran))
            theirs = ref.core.CompressionConfig(
                qw=ref.core.make_compressor(comp),
                granularity=ref.core.Granularity(gran))
        jstep = _jax_step(ref, jcfg, theirs)
        sched = piecewise_linear(0.05, 3, 1)
        jtest, ttest = _batch_pair(ref, 99, 32)
        for i in range(3):
            jb, tb = _batch_pair(ref, 10 + i, 16)
            lr = sched(i)
            jp, jv = jstep(jp, jv, jb, jax.random.fold_in(jkey(5), i),
                           jnp.float32(lr.item()))
            tp, tv, _ = train_step(cfg, mine, tp, tv, tb,
                                   R.fold_in(R.key(5), i), lr,
                                   workers=WORKERS)
            want = float(ref.cnn.cnn_loss(jcfg, jp, jtest))
            got = float(cnn.cnn_loss(cfg, tp, ttest))
            assert np.isfinite(got)
            np.testing.assert_allclose(got, want, rtol=rtol)


def test_port_data_and_init_shapes():
    from repro_torch import random as R
    from repro_torch.configs.resnet9_cifar import RESNET9
    from repro_torch.data.synthetic import classification_batch
    from repro_torch.models.cnn import init_cnn
    a = classification_batch(R.key(3), 8, device="cpu")
    b = classification_batch(R.key(3), 8, device="cpu")
    assert a["images"].shape == (8, 32, 32, 3)
    assert a["images"].dtype == torch.float32
    assert torch.equal(a["images"], b["images"])
    assert torch.equal(a["labels"], b["labels"])
    p = init_cnn(RESNET9, R.key(0), device="cpu")
    assert p["conv1_w"].shape == (3, 3, 16, 32)
    assert sum(v.numel() for v in p.values()) == 121002


def test_compare_granularities_runs_on_the_cpu():
    """The port's experiment end to end on the CPU (plain versions): one
    step per granularity and the dense baseline, finite accuracies."""
    from repro_torch.experiment import compare_granularities
    out = compare_granularities("mlp", "terngrad", steps=2, device="cpu")
    assert sorted(out) == ["baseline", "entire_model", "layerwise"]
    assert all(0.0 <= v <= 1.0 for v in out.values())
