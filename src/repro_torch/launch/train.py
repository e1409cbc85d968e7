"""End-to-end training launcher with checkpoint-restart and fault handling.

The port's counterpart of ``repro/launch/train.py``.  Drives any
registered arch of the ``lm``, ``recsys`` or ``gnn`` family at its *smoke*
config on one device: data -> step -> watchdog -> async checkpoint ->
resume.  Random weights come from a ``torch.Generator`` seeded ``--seed``;
``--device`` defaults to ``cuda``.

    python -m repro_torch.launch.train --arch minicpm-2b \\
        --steps 200 --ckpt-dir /tmp/ckpt --ckpt-every 50

Restart the same command after killing it: training resumes from the
newest complete checkpoint at the exact step (deterministic pipeline), and
the final state equals an uninterrupted run's.
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import common as cfgs
from repro_torch.data import graphs as dgraphs
from repro_torch.data import recsys as drecsys
from repro_torch.data import tokens as dtokens
from repro_torch.models import gnn, recsys
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.train import checkpoint, fault
from repro_torch.train import step as tstep


def _on(device, arrays: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in arrays.items()}


def _build(arch_id: str, batch: int, seq_len: int, opt_cfg: adamw.AdamWConfig, device=None,
           seed: int = 0):
    """``arch_id``'s smoke config -> (params, step_fn, batch_fn) on ``device``."""
    device = resolve_device(device)
    spec = cfgs.get(arch_id)
    cfg = spec.smoke_config()
    if spec.family == "lm":
        params = tfm.init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
        loss = functools.partial(tfm.loss_fn, cfg)
        pipe = dtokens.TokenPipelineConfig(vocab=cfg.vocab, batch=batch, seq_len=seq_len)

        def batch_fn(step):
            return _on(device, dtokens.batch_at(pipe, step))
    elif spec.family == "recsys":
        params = recsys.init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                                    device=device)
        loss = functools.partial(recsys.loss_fn, cfg)
        pipe = drecsys.ClickLogConfig(table_sizes=cfg.resolved_tables(), batch=batch)

        def batch_fn(step):
            return _on(device, drecsys.batch_at(pipe, step))
    elif spec.family == "gnn":
        # gnn.init draws on the CPU and moves the weights to the device
        params = gnn.init(cfg, torch.Generator().manual_seed(seed), device)
        loss = functools.partial(gnn.loss_fn, cfg)
        gb = dgraphs.synthetic_graph(512, 2048, cfg.d_in, seed=0, n_classes=cfg.d_out)
        arrays = _on(device, {"nf": gb.nf, "src": gb.src, "dst": gb.dst, "pos": gb.pos,
                              "targets": gb.targets})
        g = gnn.Graph(nf=arrays["nf"], src=arrays["src"], dst=arrays["dst"], pos=arrays["pos"])

        def batch_fn(step):
            return {"graph": g, "targets": arrays["targets"]}
    else:
        raise ValueError(f"train launcher does not drive family {spec.family!r}")
    return params, tstep.make_train_step(loss, opt_cfg), batch_fn


def main(argv=None) -> dict:
    """Run the launcher; returns the final ``state``, this run's ``losses``,
    its ``start_step``, the ``stragglers`` and the checkpoints ``written``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="the weights' generator seed")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    opt_cfg = adamw.AdamWConfig(
        lr=args.lr, warmup_steps=max(args.steps // 20, 1), total_steps=args.steps
    )
    params, step_fn, batch_fn = _build(args.arch, args.batch, args.seq_len, opt_cfg, device,
                                       args.seed)

    start_step = 0
    state = tstep.init_state(params)
    ckpt = None
    if args.ckpt_dir:  # the fresh state is the structure a checkpoint restores into
        state, start_step = fault.resume_or_init(lambda: state, args.ckpt_dir,
                                                 shardings=device)
        ckpt = checkpoint.AsyncCheckpointer(args.ckpt_dir)
        if start_step:
            print(f"resumed from checkpoint at step {start_step}")

    dog = fault.StepWatchdog()
    losses = []
    for step in range(start_step, args.steps):
        dog.start()
        state, metrics = step_fn(state, batch_fn(step))
        loss = float(metrics["loss"])
        verdict = dog.stop()
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            lr = float(adamw.wsd_schedule(opt_cfg, torch.tensor(step, dtype=torch.int32)))
            print(f"step {step:5d} loss {loss:.4f} lr {lr:.2e} {verdict}")
        if ckpt is not None and (step + 1) % args.ckpt_every == 0:
            ckpt.submit(state, step)
    if ckpt is not None:
        ckpt.submit(state, args.steps - 1)
        ckpt.wait()
    if losses:
        first = np.mean(losses[: max(len(losses) // 10, 1)])
        last = np.mean(losses[-max(len(losses) // 10, 1):])
        print(f"loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'}); "
              f"stragglers: {len(dog.stragglers)}")
    return {"state": state, "losses": losses, "start_step": start_step,
            "stragglers": list(dog.stragglers), "written": list(ckpt.written) if ckpt else []}


if __name__ == "__main__":
    main()
