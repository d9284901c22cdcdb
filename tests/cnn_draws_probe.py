"""Where the CNN study's dense accuracy comes from (a CPU diagnostic, not a
test module: pytest does not collect it).

The port's train_cnn step is held against the reference's for 3 steps
(test_torch_model.py::test_three_train_steps), and its init
(models/cnn.py) and data (data/synthetic.py) draw the reference's numbers
(repro_torch.random's normal / randint; tests/test_torch_draws.py holds
them). This script trains resnet9 without compression for `--steps` steps
four ways, crossing the two inits with the two data streams, and prints
each run's test accuracy and test loss beside the reference's own
train_cnn:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/cnn_draws_probe.py \\
        --steps 60
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_ref import ROOT, reference  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--model", default="resnet9")
    args = ap.parse_args(argv)
    import jax
    from repro_torch import experiment as E
    from repro_torch.convert import params_from_jax, tree_map
    from repro_torch.data.synthetic import classification_batch
    from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn
    from repro_torch.optim.schedules import piecewise_linear
    from repro_torch.random import fold_in, key as make_key
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    def host(b):
        return {"images": torch.from_numpy(np.array(b["images"])),
                "labels": torch.from_numpy(
                    np.asarray(b["labels"]).astype(np.int64))}
    with reference("benchmarks.common") as ref:
        jkey = jax.random.key(0)
        jcfg = ref.common.MODELS[args.model]
        jp = {k: np.asarray(v) for k, v in
              ref.cnn.init_cnn(jcfg, jkey).items()}
        ref_data = ([host(ref.synthetic.classification_batch(
            jax.random.fold_in(jkey, i), 64)) for i in range(args.steps)],
            host(ref.synthetic.classification_batch(
                jax.random.fold_in(jkey, 999_999), 256)))
        acc, loss = ref.common.train_cnn(args.model, None, steps=args.steps)
    print(f"reference train_cnn: acc {acc} loss {loss}")
    cfg = E.MODELS[args.model]
    key = make_key(0)
    port_data = ([classification_batch(fold_in(key, i), 64, device="cpu")
                  for i in range(args.steps)],
                 classification_batch(fold_in(key, 999_999), 256,
                                      device="cpu"))
    sched = piecewise_linear(E.LR[args.model], args.steps,
                             max(1, args.steps // 8))
    for init in ("reference", "port"):
        for data in ("reference", "port"):
            params = (params_from_jax(jp, device="cpu") if init ==
                      "reference" else init_cnn(cfg, key, device="cpu"))
            vel = tree_map(torch.zeros_like, params)
            batches, test = ref_data if data == "reference" else port_data
            for i in range(args.steps):
                params, vel, _ = E.train_step(
                    cfg, None, params, vel, batches[i],
                    fold_in(key, 10_000 + i), sched(i))
            with torch.no_grad():
                print(f"port train_step, {init} init, {data} data: acc "
                      f"{float(cnn_accuracy(cfg, params, test))} loss "
                      f"{float(cnn_loss(cfg, params, test))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
