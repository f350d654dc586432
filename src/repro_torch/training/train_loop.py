"""Training loop: steps are FaaS functions ("serverless supercomputing").

Port of ``repro.training.train_loop``. The trainer registers its train step
on a FaaS endpoint and submits each step as a function invocation: the
endpoint re-executes a step lost to a worker failure (``max_retries=2``), and
the checkpointer bounds lost work on a controller failure. The step is
registered ``pass_through`` with ``serialize_result=False``, so the weights,
optimizer state and batch (tensors on the card) never go through the wire.

The model holds its weights: the trainer draws them from ``seed`` into the
model in place, makes them trainable, and the step updates them in place.
Batches go to the model's device on the prefetcher's thread.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from ..checkpoint.checkpointer import Checkpointer
from ..core.service import FunctionService
from ..data.pipeline import Prefetcher, token_stream
from ..models.model import Model
from . import optimizer as opt
from .steps import build_train_step


@dataclass
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 128
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    prefetch_depth: int = 2
    log_every: int = 10
    resume: bool = True


class Trainer:
    def __init__(
        self,
        model: Model,
        ocfg: opt.OptimizerConfig,
        tcfg: TrainConfig,
        service: Optional[FunctionService] = None,
        endpoint_id: Optional[str] = None,
        seed: int = 0,
    ):
        self.model = model
        self.ocfg = ocfg
        self.tcfg = tcfg
        self.service = service
        self.endpoint_id = endpoint_id
        self.history: List[Dict[str, float]] = []

        self._step_fn = build_train_step(model, ocfg).fn

        model.init(torch.Generator(device=model.device).manual_seed(seed))
        model.requires_grad_(True)
        self.params = model.params
        self.opt_state = opt.init_state(self.params, ocfg)
        self.step = 0

        self.ckpt = Checkpointer(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
        if self.ckpt and tcfg.resume and self.ckpt.latest_step() is not None:
            self.step, state = self.ckpt.restore({"params": self.params, "opt": self.opt_state})
            self._load(state)

        self._fid = None
        if service is not None:
            # pass_through + unserialized results: device tensors never hit the
            # wire; the FaaS layer provides routing, warming, retry, telemetry.
            def train_step_function(doc):
                return self._step_fn(doc["params"], doc["opt"], doc["batch"])

            self._fid = service.register_function(
                train_step_function,
                name=f"train_step/{model.cfg.name}",
                pass_through=True,
                serialize_result=False,
                static=repr((model.cfg, ocfg)),
            )

    @torch.no_grad()
    def _load(self, state) -> None:
        """Copy a restored tree into the model's weights and the optimizer
        state, in place (the step counter is replaced)."""
        opt.tree_map(lambda dst, src: dst.copy_(src), self.params, state["params"])
        saved = state["opt"]
        for name in ("master", "mu", "nu"):
            opt.tree_map(lambda dst, src: dst.copy_(src), self.opt_state[name], saved[name])
        self.opt_state["step"] = saved["step"].to(self.model.device)

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.model.device) for k, v in batch.items()}

    def _run_one(self, batch) -> Dict[str, float]:
        doc = {"params": self.params, "opt": self.opt_state, "batch": batch}
        if self.service is not None:
            fut = self.service.run(self._fid, doc, endpoint_id=self.endpoint_id,
                                   max_retries=2)
            self.params, self.opt_state, metrics = fut.result(timeout=600)
        else:
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, doc["batch"]
            )
        return {k: float(v) for k, v in metrics.items()}

    def _save(self, blocking: bool = False) -> None:
        self.ckpt.save(self.step, {"params": self.params, "opt": self.opt_state},
                       blocking=blocking)

    def run(self) -> List[Dict[str, float]]:
        cfg, t = self.model.cfg, self.tcfg
        stream = token_stream(cfg, t.batch, t.seq, start_step=self.step)
        pf = Prefetcher(stream, depth=t.prefetch_depth, transform=self._to_device)
        t0 = time.monotonic()
        saved = None   # the step of the last save this run started
        try:
            while self.step < t.steps:
                batch = next(pf)
                metrics = self._run_one(batch)
                self.step += 1
                metrics["step"] = self.step
                metrics["wall_s"] = time.monotonic() - t0
                self.history.append(metrics)
                if t.log_every and self.step % t.log_every == 0:
                    print(
                        f"step {self.step:5d} loss {metrics['loss']:.4f} "
                        f"grad_norm {metrics['grad_norm']:.3f} lr {metrics['lr']:.2e}",
                        flush=True,
                    )
                if self.ckpt and self.step % t.ckpt_every == 0:
                    self._save()
                    saved = self.step
        finally:
            pf.close()
            if self.ckpt:
                # the last step's checkpoint, written before returning (the
                # reference writes it again when the loop just saved it)
                if saved == self.step:
                    self.ckpt.wait()
                else:
                    self._save(blocking=True)
        return self.history
