"""Train / prefill / decode steps (port of ``repro.launch.steps``).

``make_state_defs`` declares (params, opt state) as ParamDef trees, as
in the reference.  The train step is ``(state, batch) -> (state,
metrics)`` with ``state = (model, OptState)``: the model holds the
weights as parameters that require grad, and the state's moments keep
the reference's stacked layout.  A step is a plain function; it updates
the model and the moments in place (the reference donates them) and
returns the same objects with a new step count.

Under ``torch.compile`` (``core.harness.compile_step``, the ``jit*``
modes) the train step compiles into two graphs, with one graph break
left, at ``loss.backward()`` (Dynamo does not trace ``Tensor.backward``):
the forward to the loss, whose AOT-autograd backward ``backward()`` runs
(the flash-attention backward op inside it), and the gradients' AdamW
update after it.  The moments' per-parameter views are taken before the
break, so the update graph updates them in place as its inputs; taken
after it, the stacked moments were its inputs and their updated copies
its temporaries, 18 GB more than eager at gemma-2b's width.  With ``microbatches`` > 1 each microbatch's
``backward()`` breaks the graph once more.  The prefill and decode steps
compile into one graph each, with no break.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Tuple

import torch

from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig, OptState, adamw_update, opt_state_defs
from repro_torch.optim.schedule import cosine_schedule


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    microbatches: int = 1       # gradient accumulation over the batch dim


def make_state_defs(model) -> Tuple[Any, OptState]:
    pdefs = model.param_defs()
    return pdefs, opt_state_defs(pdefs)


def make_train_step(cfg, hyper: TrainHyper = TrainHyper(),
                    opt_cfg: AdamWConfig = AdamWConfig()):
    """-> train_step.  The reference returns its (stateless) model beside
    the step; the port's model lives in the state, which the caller
    builds (``core.suite``)."""

    def grads_of(model, batch: Mapping[str, torch.Tensor]):
        params = list(model.parameters())
        if hyper.microbatches <= 1:
            loss, metrics = model.loss(batch)
            loss.backward()
            return [p.grad for p in params], metrics
        mb = hyper.microbatches
        B = batch["tokens"].shape[0]
        if B % mb:
            raise ValueError(f"batch {B} is not a multiple of microbatches {mb}")
        # fp32 sums over the microbatches, as the reference's scan carries
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
        loss_sum = torch.zeros((), device=params[0].device)
        for i in range(mb):
            part = {k: v[i * (B // mb):(i + 1) * (B // mb)] for k, v in batch.items()}
            loss, _ = model.loss(part)
            loss.backward()
            with torch.no_grad():
                torch._foreach_add_(acc, [p.grad.float() for p in params])
                loss_sum = loss_sum + loss
            for p in params:
                p.grad = None
        torch._foreach_div_(acc, mb)
        return acc, {"loss": loss_sum / mb, "ppl": torch.exp(loss_sum / mb)}

    def train_step(state, batch):
        model, opt = state
        # the moments' per-parameter views, taken before the backward: a
        # compiled step's update graph gets them as its inputs, which it
        # updates in place (taken in that graph, the stacked moments would
        # be its inputs, and their updated copies its temporaries)
        moments = OptState(opt.step, model.leaf_views(opt.mu), model.leaf_views(opt.nu))
        grads, metrics = grads_of(model, batch)
        lr = cosine_schedule(opt.step, hyper.warmup_steps, hyper.total_steps, hyper.lr)
        _, moments, om = adamw_update(list(model.parameters()), grads, moments,
                                      opt_cfg, lr=lr)
        for p in model.parameters():    # no gradient lives between steps
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (model, OptState(moments.step, opt.mu, opt.nu)), {**metrics, **om, "lr": lr}

    return train_step


def make_prefill_step(cfg, max_len: int, *, device="cuda", seed: int = 0):
    model = build_model(cfg, device=device, seed=seed)

    def prefill_step(model, batch, cache):
        return model.prefill(batch, cache)

    return prefill_step, model


def make_decode_step(cfg, *, device="cuda", seed: int = 0):
    model = build_model(cfg, device=device, seed=seed)

    def serve_step(model, tokens, cache):
        return model.decode_step(tokens, cache)

    return serve_step, model
