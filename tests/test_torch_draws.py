"""The CNN study's draws against the reference's (ROADMAP Queue 3 item
17): repro_torch.random's normal and randint against jax.random, the CNN
init, the class prototypes and classification batches against the JAX
package's, and train_cnn from the port's own draws against the
reference's train_cnn.

Stated bounds (the largest seen in brackets):
  - normal: bitwise the jitted jax.random.normal (XLA's erf_inv, log1p and
    log expansions with its fmas, written out);
  - randint, the labels and every init_cnn weight: bitwise;
  - the prototypes: within one f32 ulp of their largest magnitude,
    2^-21 at |p| < 8 (4.77e-7): jax.image.resize contracts with XLA's CPU
    dot, which rounds its sums in another order;
  - the images: within two such ulps, 9.54e-7 (9.54e-7);
  - train_cnn, 3 dense steps: test loss within 1e-4 relative (Queue 3
    item 2), accuracy within one test image of 256.

The reference's train_cnn runs in a subprocess the module's first test
starts (its jit compiles overlap the other cases).
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_ref import reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
ULP8 = 2.0 ** -21          # one f32 ulp in [4, 8)
TRAIN_MODELS = ("mlp", "resnet9")
REF_TIMEOUT = 600.0


def reference_train_cnn_main(out_path: str) -> None:
    """The reference's train_cnn(model, None, steps=3) of TRAIN_MODELS ->
    {model: [accuracy, test loss]} as JSON at out_path."""
    with reference("benchmarks.common") as ref:
        res = {m: list(ref.common.train_cnn(m, None, steps=3))
               for m in TRAIN_MODELS}
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(res, f)
    os.replace(tmp, out_path)


@pytest.fixture(scope="module", autouse=True)
def reference_train(tmp_path_factory):
    """Start the reference's train_cnn runs with the module's first test;
    -> a function that waits for their results."""
    out = str(tmp_path_factory.mktemp("draws") / "train_cnn.json")
    # one XLA thread: beside loaded test workers, spinning pools thrash
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests"), str(ROOT)]))
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_draws as t; "
         "t.reference_train_cnn_main(sys.argv[1])", out], env=env,
        cwd=str(ROOT / "tests"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)

    def results():
        log, _ = proc.communicate(timeout=REF_TIMEOUT)
        assert proc.returncode == 0, log[-4000:]
        with open(out) as f:
            return json.load(f)
    yield results
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.mark.parametrize("seed,shape", [
    (0, (7,)), (3, (4096,)), (1234, (10, 4, 4, 3)), (77, (5, 3)),
    (2 ** 31 - 1, (3, 3, 16, 32)), (11, (1,))])
def test_normal_bitwise(seed, shape):
    from repro_torch import random as R
    with reference():
        want = np.asarray(jax.jit(lambda k: jax.random.normal(k, shape))(
            jax.random.key(seed)))
    got = R.normal(R.key(seed), shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed,shape,lo,hi", [
    (0, (16,), 0, 10), (5, (1000,), 0, 10), (9, (33,), -3, 1000),
    (2, (8,), 0, 1), (4, (2, 5), 7, 3), (6, (257,), 0, 2 ** 31 - 1)])
def test_randint_bitwise(seed, shape, lo, hi):
    from repro_torch import random as R
    with reference():
        want = np.asarray(jax.random.randint(jax.random.key(seed), shape,
                                             lo, hi))
    got = R.randint(R.key(seed), shape, lo, hi).numpy()
    assert got.shape == shape
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_normal_edges_and_device():
    """u = +-1 can not occur (the uniform is clamped to
    nextafter(-1, 0)); erf_inv still maps +-1 to +-inf, as XLA's; the
    draws are made on the CPU whatever device the key is on."""
    from repro_torch import random as R
    x = torch.tensor([-1.0, 1.0, 0.0, -0.5])
    out = R._erf_inv_f32(x)
    assert out[0] == -torch.inf and out[1] == torch.inf and out[2] == 0
    assert R.normal(R.key(3), (4,)).device.type == "cpu"


@pytest.mark.parametrize("kind", ["mlp", "alexnet", "resnet9"])
def test_init_cnn_matches_reference(kind):
    from repro_torch import random as R
    from repro_torch.configs import resnet9_cifar as TC
    from repro_torch.models.cnn import init_cnn
    name = {"mlp": "MLP", "alexnet": "ALEXNET", "resnet9": "RESNET9"}[kind]
    with reference("repro.configs.resnet9_cifar") as ref:
        # eager, as train_cnn calls it (one jit of the whole init fuses
        # std * normal into other roundings)
        want = ref.cnn.init_cnn(getattr(ref.resnet9_cifar, name),
                                jax.random.key(4))
        want = {k: np.asarray(v) for k, v in want.items()}
    got = init_cnn(getattr(TC, name), R.key(4), device="cpu")
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_class_prototypes_within_bound():
    from repro_torch.data.synthetic import _class_prototypes
    with reference() as ref:
        want = np.asarray(jax.jit(ref.synthetic._class_prototypes,
                                  static_argnums=(0, 1, 2))(10, 32, 3))
    got = _class_prototypes(10, 32, 3).numpy()
    assert np.abs(want).max() < 8
    assert np.abs(got - want).max() <= ULP8
    # most entries are bitwise (85% seen)
    assert (got == want).mean() > 0.5


@pytest.mark.parametrize("seed,batch", [(0, 16), (77, 16), (999_999, 16)])
def test_classification_batch_matches_reference(seed, batch):
    from repro_torch import random as R
    from repro_torch.data.synthetic import classification_batch
    with reference() as ref:
        jb = ref.synthetic.classification_batch(jax.random.key(seed), batch)
        want_l = np.asarray(jb["labels"])
        want_x = np.asarray(jb["images"])
    tb = classification_batch(R.key(seed), batch, device="cpu")
    np.testing.assert_array_equal(tb["labels"].numpy(),
                                  want_l.astype(np.int64))
    got = tb["images"].numpy()
    assert got.dtype == np.float32 and got.shape == want_x.shape
    assert np.abs(want_x).max() < 8
    assert np.abs(got - want_x).max() <= 2 * ULP8


@pytest.mark.parametrize("model", TRAIN_MODELS)
def test_train_cnn_from_own_draws_matches_reference(model, reference_train):
    from repro_torch.experiment import train_cnn
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # the same reason as the subprocess's flags
    try:
        acc, loss = train_cnn(model, None, steps=3, device="cpu")
    finally:
        torch.set_num_threads(threads)
    want_acc, want_loss = reference_train()[model]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
    assert abs(acc - want_acc) <= 1 / 256 + 1e-9
