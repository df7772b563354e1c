"""Train a small model end-to-end on the synthetic pipeline with the
from-scratch AdamW + cosine schedule, then checkpoint and restore, on the
PyTorch port (on the card unless ``--device cpu`` is given).

  PYTHONPATH=src python examples/train_small_torch.py [--steps 60] [--device cpu]

(The paper's kind is serving, so the flagship end-to-end driver is
serve_fleet_torch.py; this exercises the full training substrate: data ->
train_step -> optimizer -> checkpoint -> restore -> eval.)
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.launch.train import to_batch
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train_step import build_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    api = build_model(cfg)
    params = api.init(0, dtype=torch.float32, device=device)
    opt_cfg = OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=args.steps)
    opt_state = init_opt_state(params)
    step = build_train_step(api, opt_cfg)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, args.seq, args.batch, seed=0))

    first = last = None
    t0 = time.time()
    for i in range(args.steps):
        params, opt_state, m = step(params, opt_state, to_batch(data.batch(i), cfg, device))
        loss = float(m["loss"])
        first = first if first is not None else loss
        last = loss
        if i % 10 == 0:
            print(f"step {i:4d} loss={loss:.4f}", flush=True)
    print(f"loss {first:.3f} -> {last:.3f} in {args.steps} steps "
          f"({(time.time()-t0)/args.steps:.2f}s/step)")
    assert last < first, "training must reduce loss"

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ck.npz")
        ckpt.save(path, {"params": params})
        restored = ckpt.restore(path, {"params": params}, device=device)["params"]
    batch = to_batch(data.batch(0), cfg, device)
    l1, _ = api.train_loss(params, batch)
    l2, _ = api.train_loss(restored, batch)
    print(f"checkpoint roundtrip: loss {float(l1):.6f} == {float(l2):.6f}")
    assert float(l1) == float(l2)
    return {"first": first, "last": last, "restored_loss": float(l2)}


if __name__ == "__main__":
    main()
