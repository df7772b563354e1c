"""Training launcher (port of ``repro/launch/train.py``).

Reduced configs train for real anywhere; published widths need the card.
Runs on ``cuda`` unless ``--device cpu`` is given, and refuses to start
without a CUDA device otherwise.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b --reduced \\
      --steps 100 --batch 8 --seq 128 --ckpt /tmp/ck.npz
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train_step import build_train_step


def to_batch(raw: dict, cfg: ModelConfig, device) -> dict:
    """A ``SyntheticTokens`` batch on ``device``, with the vision and enc-dec
    stubs' zero ``frontend_embeds`` as the reference's launcher builds them."""
    batch = {k: torch.from_numpy(v).to(device=device, dtype=torch.int64) for k, v in raw.items()}
    b, s = raw["tokens"].shape
    if cfg.frontend == "vision":
        fe = min(cfg.frontend_tokens, s)
        batch["frontend_embeds"] = torch.zeros((b, fe, cfg.d_model), dtype=torch.bfloat16,
                                               device=device)
    if cfg.arch_type == "encdec":
        batch["frontend_embeds"] = torch.zeros((b, s, cfg.d_model), dtype=torch.bfloat16,
                                               device=device)
    return batch


def opt_config(lr: float, steps: int) -> OptimizerConfig:
    """The launcher's AdamW: warmup over a twentieth of the run, cosine to its end."""
    return OptimizerConfig(lr=lr, warmup_steps=max(steps // 20, 1), total_steps=steps)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    api = build_model(cfg)
    params = api.init(args.seed, device=device)
    opt_state = init_opt_state(params)
    step_fn = build_train_step(api, opt_config(args.lr, args.steps))
    data = SyntheticTokens(DataConfig(cfg.vocab_size, args.seq, args.batch, args.seed))

    t0 = time.time()
    for i in range(args.steps):
        batch = to_batch(data.batch(i), cfg, device)
        params, opt_state, m = step_fn(params, opt_state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} lr={float(m['lr']):.2e} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
    if args.ckpt:
        ckpt.save(args.ckpt, {"params": params, "opt": opt_state})
        print(f"checkpoint -> {args.ckpt}")


if __name__ == "__main__":
    main()
