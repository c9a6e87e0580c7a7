"""Training and evaluation loops.

Counterpart of ``dmlc_core_tpu/models/train.py``, for one card:
``make_train_step``, ``make_eval_step``, ``streaming_auc``,
``auc_from_histograms``, ``evaluate_stream`` and ``fit_stream`` with its
per-step loop.  A model is an ``nn.Module`` with ``forward(batch)`` and
``loss(batch)``; the optimizer is a ``torch.optim`` one.  ``optax.adam``
maps to ``torch.optim.Adam(params, lr, betas=(0.9, 0.999), eps=1e-8)``:
both step by ``lr·m̂/(√v̂ + eps)``.

No step reads a value back to the host: losses and eval sums stay on
the device until the caller reads them.  The k-step fused trainer, mesh
shardings and the fused wire stay with the JAX package for now.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..utils.logging import log_info

__all__ = ["make_train_step", "make_eval_step", "streaming_auc",
           "auc_from_histograms", "evaluate_stream", "fit_stream", "adam"]

Batch = Dict[str, torch.Tensor]


def adam(model: torch.nn.Module, lr: float = 1e-3) -> torch.optim.Adam:
    """The port's ``optax.adam(lr)``: same betas and eps, and the same
    place for eps (outside the square root)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer
                    ) -> Callable[[Batch], torch.Tensor]:
    """``step(batch) -> loss``: one gradient step; the loss is a 0-d
    tensor on the model's device (no host sync)."""
    def step(batch: Batch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = model.loss(batch)
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step


def make_eval_step(model: torch.nn.Module
                   ) -> Callable[[Batch], Tuple[torch.Tensor, torch.Tensor]]:
    """``evaluate(batch) -> (correct, total)``: weighted count of rows
    whose sign of the score matches the label, and the weight."""
    @torch.no_grad()
    def evaluate(batch: Batch):
        return _accuracy(model(batch), batch)
    return evaluate


def _accuracy(out: torch.Tensor, batch: Batch):
    w = batch["weights"]
    pred = (out > 0).to(w.dtype)
    y = (batch["labels"] > 0).to(w.dtype)
    return (w * (pred == y).to(w.dtype)).sum(), w.sum()


def streaming_auc(scores: torch.Tensor, labels: torch.Tensor,
                  weights: torch.Tensor, num_bins: int = 1024
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch's weighted positive / negative histograms over fixed
    ``[0, 1]`` bins of ``sigmoid(score)``; batches add up.  Combine with
    :func:`auc_from_histograms`."""
    p = torch.sigmoid(scores)
    idx = torch.clamp((p * num_bins).to(torch.int64), 0, num_bins - 1)
    y = (labels > 0).to(weights.dtype)
    pos = weights.new_zeros(num_bins).index_add_(0, idx, weights * y)
    neg = weights.new_zeros(num_bins).index_add_(0, idx,
                                                 weights * (1.0 - y))
    return pos, neg


def auc_from_histograms(pos: torch.Tensor, neg: torch.Tensor
                        ) -> torch.Tensor:
    """AUC of the binned distributions (trapezoid over the ROC steps;
    ties within a bin count half)."""
    total_pos = torch.clamp(pos.sum(), min=1e-12)
    total_neg = torch.clamp(neg.sum(), min=1e-12)
    neg_below = torch.cat([neg.new_zeros(1), torch.cumsum(neg, 0)[:-1]])
    wins = (pos * (neg_below + 0.5 * neg)).sum()
    return wins / (total_pos * total_neg)


def evaluate_stream(model: torch.nn.Module, loader, *,
                    auc: bool = True) -> Dict[str, float]:
    """One pass over ``loader``: weighted accuracy and, with ``auc``, the
    streaming binned ROC-AUC, from one forward per batch.  Sums stay on
    the device until the end."""
    correct = total = pos = neg = None
    with torch.no_grad():
        for batch in loader:
            out = model(batch)
            c, t = _accuracy(out, batch)
            correct = c if correct is None else correct + c
            total = t if total is None else total + t
            if auc:
                a, b = streaming_auc(out, batch["labels"], batch["weights"])
                pos = a if pos is None else pos + a
                neg = b if neg is None else neg + b
    if correct is None:
        out = {"accuracy": 0.0, "weight": 0.0}
        if auc:
            out["auc"] = 0.0
        return out
    total_f = float(total)
    out = {"accuracy": float(correct) / max(total_f, 1e-9),
           "weight": total_f}
    if auc:
        out["auc"] = float(auc_from_histograms(pos, neg))
    return out


def fit_stream(model: torch.nn.Module, loader, *, epochs: int = 1,
               optimizer: Optional[torch.optim.Optimizer] = None,
               log_every: int = 100) -> List[float]:
    """Streaming training, one pass of the loader per epoch, one step per
    batch.  The optimizer defaults to Adam(1e-2), as the JAX package's
    ``optax.adam(1e-2)``.  Returns the losses sampled every
    ``log_every`` steps (reading one back syncs the host)."""
    optimizer = optimizer or adam(model, 1e-2)
    step_fn = make_train_step(model, optimizer)
    step = 0
    history: List[float] = []
    for epoch in range(epochs):
        t0 = time.monotonic()
        for batch in loader:
            loss = step_fn(batch)
            step += 1
            if log_every and step % log_every == 0:
                history.append(float(loss))
                log_info("epoch %d step %d loss %.5f", epoch, step,
                         history[-1])
        loader.before_first()
        log_info("epoch %d done in %.2fs (%d steps)", epoch,
                 time.monotonic() - t0, step)
    return history
