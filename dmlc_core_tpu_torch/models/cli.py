"""``dmlc-train`` of the port: config-file-driven training on the card.

Counterpart of ``dmlc_core_tpu/models/cli.py``, run as

    python -m dmlc_core_tpu_torch.models.cli train.conf model=deepfm data=train.libsvm

with the same ``TrainParams`` keys and defaults, the same ``key=value``
and config-file grammar (CLI pairs override the file; unknown keys and
bad values fail before any data is read) and the same printed lines.
One key more: ``device`` (``cuda``, or ``cpu`` for the plain PyTorch
path), the counterpart of ``JAX_PLATFORMS``; it is never read from the
environment, and without a card ``device=cuda`` exits 2.

It trains on the flat layout, through ``DeviceLoader(create_parser(...),
batch_rows, nnz_cap, id_mod=features)`` (the threaded native parser and
the native packer wherever g++ exists, as the JAX CLI's loader), with
``optax.adam``'s update
(``models.train.adam``).  A checkpoint holds ``params`` (the JAX param
tree) and ``opt_state`` in ``optax.adam``'s layout
(:func:`.convert.adam_state_to_optax`), so either package's ``resume``
and ``mode=predict`` read the other's checkpoints.  ``ckpt_every`` saves
synchronously at the steps where the JAX CLI's ``save_async`` saves.
At the end of a run one line on stderr gives the host-clock seconds of
its stages from ``main`` on: set-up, the kernel and native build checks,
the optimizer's set-up (or a resume), the wait for the first batch, the
steps, validation, the train AUC and the checkpoint (or, to predict, the
scoring).

Not ported yet; each exits 2 naming what is missing: ``model=ffm`` (libfm
fields), ``format=libfm|csv``, ``workers=`` (remote ingest), ``kstep>1``
(the fused k-step trainer) and URIs other than local files.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..utils.config import Config
from ..utils.logging import DMLCError, log_info
from ..utils.parameter import ParamError, Parameter, field
from ..utils.registry import Registry

MODEL_REGISTRY = Registry.get("model")

# models the JAX CLI has that the port cannot train yet: name -> reason
_NOT_PORTED = {"ffm": "model=ffm needs libfm fields, which are not ported "
                      "yet (the libfm parser and FieldAwareFM)"}


@MODEL_REGISTRY.register("logreg", "sparse logistic regression")
def _logreg(p: "TrainParams", device: torch.device,
            generator: torch.Generator):
    from .sparse import SparseLogReg
    return SparseLogReg(num_features=p.features, l2=p.l2, device=device)


@MODEL_REGISTRY.register("fm", "factorization machine")
def _fm(p: "TrainParams", device: torch.device, generator: torch.Generator):
    from .sparse import FactorizationMachine
    return FactorizationMachine(num_features=p.features, dim=p.dim, l2=p.l2,
                                task=p.task, device=device,
                                generator=generator)


@MODEL_REGISTRY.register("deepfm", "FM + deep tower")
def _deepfm(p: "TrainParams", device: torch.device,
            generator: torch.Generator):
    from .deep import DeepFM
    return DeepFM(num_features=p.features, dim=p.dim, layers=p.layers,
                  l2=p.l2, task=p.task, device=device, generator=generator)


@MODEL_REGISTRY.register("dcn", "deep & cross network v2")
def _dcn(p: "TrainParams", device: torch.device, generator: torch.Generator):
    from .dcn import DCNv2
    return DCNv2(num_features=p.features, dim=p.dim, layers=p.layers,
                 l2=p.l2, task=p.task, device=device, generator=generator)


class TrainParams(Parameter):
    """All knobs of a training run (printed by ``--help``)."""

    data = field(str, help="training data URI")   # no default → required
    mode = field(str, default="train", enum=["train", "predict"],
                 help="predict: restore ckpt_dir's latest and write "
                      "scores for `data` to `output` (xgboost task=pred)")
    output = field(str, default="",
                   help="predictions file (predict mode; local files)")
    workers = field(str, default="",
                    help="comma-separated host:port ingest workers (not "
                         "ported: must stay empty)")
    valid = field(str, default="",
                  help="validation data URI: accuracy/AUC printed per "
                       "epoch (the reference ecosystem's watchlist)")
    format = field(str, default="auto",
                   enum=["auto", "libsvm", "libfm", "csv"],
                   help="input format ('auto': ?format= URI arg, then file "
                        "suffix .libsvm/.libfm/.csv, then libsvm); only "
                        "libsvm is ported")
    # lazy enum: registering a model is the only step to join the CLI
    model = field(str, default="fm",
                  enum=lambda: sorted(MODEL_REGISTRY.list_names()
                                      + list(_NOT_PORTED)),
                  help="registered model name")
    features = field(int, default=1 << 20, lower_bound=1,
                     help="feature-space size (ids hashed into it)")
    fields = field(int, default=40, lower_bound=1,
                   help="field count (ffm)")
    dim = field(int, default=16, lower_bound=1, help="factor dimension")
    layers = field(int, default=2, lower_bound=1,
                   help="depth: deepfm tower / dcn cross layers")
    task = field(str, default="binary", enum=["binary", "regression"])
    epochs = field(int, default=1, lower_bound=1)
    batch_rows = field(int, default=4096, lower_bound=1)
    nnz_cap = field(int, default=131072, lower_bound=1)
    lr = field(float, default=1e-3, lower_bound=0.0)
    l2 = field(float, default=0.0, lower_bound=0.0)
    seed = field(int, default=0)
    ckpt_dir = field(str, default="", help="checkpoint dir URI ('' = off)")
    ckpt_every = field(int, default=0, lower_bound=0,
                       help="checkpoint every N steps (0 = only at the "
                            "end); saved synchronously")
    resume = field(bool, default=False,
                   help="continue from the latest checkpoint in ckpt_dir "
                        "(params and optimizer state; either package's)")
    eval_auc = field(bool, default=True,
                     help="streaming AUC over the train stream at the end")
    kstep = field(int, default=1, lower_bound=1,
                  help="train steps fused per device dispatch (not "
                       "ported: must stay 1)")
    log_every = field(int, default=100)
    device = field(str, default="cuda", enum=["cuda", "cpu"],
                   help="where to train: 'cuda' (the kernels) or 'cpu' "
                        "(their plain PyTorch versions); never read from "
                        "the environment")


def _parse_argv(argv: List[str]) -> Dict[str, str]:
    """[conf-file] [key=value ...] → merged dict (CLI overrides file)."""
    conf: Dict[str, str] = {}
    args = list(argv)
    if args and "=" not in args[0]:
        with open(args[0]) as f:
            conf.update(Config(f).to_dict())
        args = args[1:]
    for a in args:
        if "=" not in a:
            raise ParamError(f"expected key=value, got {a!r}")
        k, v = a.split("=", 1)
        conf[k] = v
    return conf


def _local(uri: str) -> str:
    """The local path of ``uri`` (a plain path or ``file://``, URI
    arguments after ``?`` dropped)."""
    path = uri.split("?", 1)[0]
    return path[len("file://"):] if path.startswith("file://") else path


def _resolve_format(p: TrainParams) -> str:
    """The JAX CLI's rule: ``format=``, else a ``?format=`` URI argument,
    else the file suffix, else libsvm."""
    if p.format != "auto":
        return p.format
    for arg in p.data.partition("?")[2].split("&"):
        if arg.startswith("format="):
            return arg[len("format="):]
    base = _local(p.data).rstrip("/")
    for suf in ("libsvm", "libfm", "csv"):
        if base.endswith("." + suf):
            return suf
    return "libsvm"


def _refusal(p: TrainParams) -> Optional[str]:
    """Why the port cannot run ``p`` yet, or None."""
    if p.model in _NOT_PORTED:
        return _NOT_PORTED[p.model]
    fmt = _resolve_format(p)
    if fmt != "libsvm":
        return (f"format={fmt} is not ported yet (its parser); the port "
                f"reads libsvm")
    if p.workers:
        return ("workers= (remote ingest workers and the fused wire) is "
                "not ported yet; train on local files")
    if p.kstep > 1:
        return (f"kstep={p.kstep} needs the fused k-step trainer "
                f"(FusedTrainer), which is not ported yet; use kstep=1")
    for key in ("data", "valid", "output", "ckpt_dir"):
        uri = getattr(p, key)
        if "://" in uri and not uri.startswith("file://"):
            return (f"{key}={uri}: only local files are supported (remote "
                    f"filesystems are not ported yet)")
    return None


class _Stages:
    """Host-clock seconds of a run's stages, logged once at the end."""

    def __init__(self) -> None:
        self.t0 = self.last = time.monotonic()
        self.secs: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        """The time since the last mark goes to stage ``name``."""
        now = time.monotonic()
        self.secs[name] = self.secs.get(name, 0.0) + now - self.last
        self.last = now

    def report(self) -> None:
        log_info("dmlc-train stages (host clock): main %.3fs = %s",
                 time.monotonic() - self.t0, ", ".join(
                     f"{k} {v:.3f}s" for k, v in self.secs.items()))


def _make_loader(p: TrainParams, uri: str, device: torch.device):
    """The one place a run's loader is configured: train, validation,
    end-of-run AUC and predict all see the same batch shape and
    hashing."""
    from ..data import create_parser
    from ..pipeline import DeviceLoader
    return DeviceLoader(create_parser(_local(uri), 0, 1, "libsvm"),
                        batch_rows=p.batch_rows, nnz_cap=p.nnz_cap,
                        id_mod=p.features, device=device)


def _load_params(model, params, device: torch.device) -> None:
    from .convert import params_from_jax
    try:
        model.load_state_dict(params_from_jax(params, device))
    except (RuntimeError, KeyError) as e:
        raise DMLCError(f"checkpoint params do not fit the model: {e}") \
            from None


def _predict(p: TrainParams, model, device: torch.device,
             stages: _Stages) -> int:
    """Restore the latest checkpoint and write one score per input row to
    ``p.output`` (text, '%.6f\\n'; sigmoid for binary task)."""
    from ..utils.checkpoint import CheckpointManager

    if not p.ckpt_dir or not p.output:
        print("dmlc-train: predict mode needs ckpt_dir and output",
              file=sys.stderr)
        return 2
    mgr = CheckpointManager(_local(p.ckpt_dir))
    try:
        step_no, state = mgr.restore()
    except DMLCError as e:
        print(f"dmlc-train: {e}", file=sys.stderr)
        return 2
    meta_model = mgr.meta(step_no).get("model")
    if meta_model and meta_model != p.model:
        print(f"dmlc-train: checkpoint was trained as '{meta_model}' but "
              f"model={p.model} requested", file=sys.stderr)
        return 2
    _load_params(model, state["params"], device)
    n = 0
    loader = _make_loader(p, p.data, device)
    try:
        with open(_local(p.output), "wb") as out, torch.no_grad():
            # one score per input row: padding rows exist only at the
            # tail of the last batch, and stats.rows is the real row
            # total once iteration ends, so write with a one-batch lag
            # and trim the last batch
            held = None
            for batch in loader:
                if n == 0 and held is None:
                    stages.mark("first batch")
                scores = model(batch)
                if p.task == "binary":
                    scores = torch.sigmoid(scores)
                if held is not None:
                    out.write(b"".join(b"%.6f\n" % v for v in held))
                    n += len(held)
                held = scores.cpu().numpy().tolist()
            if held is not None:
                tail = held[:max(0, int(loader.stats.rows) - n)]
                out.write(b"".join(b"%.6f\n" % v for v in tail))
                n += len(tail)
    finally:
        loader.close()
    stages.mark("predict")
    print(f"wrote {n} predictions from step {step_no} -> {p.output}",
          flush=True)
    return 0


def _resume(p: TrainParams, model, opt, device: torch.device) -> int:
    """Params and optimizer state from the latest checkpoint (either
    package's); returns its step, 0 when there is none."""
    from ..utils.checkpoint import CheckpointManager
    from .convert import adam_state_from_optax
    try:
        start_n, state = CheckpointManager(_local(p.ckpt_dir)).restore()
    except DMLCError:
        print(f"no checkpoint in {p.ckpt_dir} — starting fresh", flush=True)
        return 0
    _load_params(model, state["params"], device)
    if "opt_state" in state:
        adam_state_from_optax(model, opt, state["opt_state"])
        print(f"resumed from step {start_n} in {p.ckpt_dir}", flush=True)
    else:
        print(f"resumed params from step {start_n} in {p.ckpt_dir} "
              "(old checkpoint without opt_state — optimizer moments "
              "reset)", flush=True)
    return start_n


def _train(p: TrainParams, model, device: torch.device,
           stages: _Stages) -> int:
    from ..utils.checkpoint import CheckpointManager
    from .convert import adam_state_to_optax, params_to_numpy
    from .train import (adam, auc_from_histograms, evaluate_stream,
                        make_train_step, streaming_auc)

    if p.resume and not p.ckpt_dir:
        print("dmlc-train: resume=true needs ckpt_dir", file=sys.stderr)
        return 2
    if p.ckpt_every and not p.ckpt_dir:
        # a long job silently writing no checkpoint is unrecoverable
        print("dmlc-train: ckpt_every needs ckpt_dir", file=sys.stderr)
        return 2
    opt = adam(model, p.lr)
    start_n = _resume(p, model, opt, device) if p.resume else 0
    step = make_train_step(model, opt)
    mgr = CheckpointManager(_local(p.ckpt_dir)) if p.ckpt_dir else None
    stages.mark("optimizer set-up")

    def save(n: int) -> None:
        mgr.save(n, {"params": params_to_numpy(model, nested=True),
                     "opt_state": adam_state_to_optax(model, opt)},
                 meta={"model": p.model, "steps": int(n)})

    def eval_valid(epoch: int) -> None:
        if not p.valid:
            return
        stages.mark("steps")
        vl = _make_loader(p, p.valid, device)
        try:
            r = evaluate_stream(model, vl, auc=p.task == "binary")
        finally:
            vl.close()
        auc = f" auc {r['auc']:.4f}" if "auc" in r else ""
        print(f"epoch {epoch} valid acc {r['accuracy']:.4f}{auc}",
              flush=True)
        stages.mark("valid")

    n, loss, saved = start_n, None, -1
    loader = _make_loader(p, p.data, device)
    try:
        for epoch in range(p.epochs):
            for batch in loader:
                if loss is None:
                    stages.mark("first batch")
                loss = step(batch)
                old, n = n, n + 1
                if p.log_every and old // p.log_every != n // p.log_every:
                    print(f"epoch {epoch} step {n} loss {float(loss):.5f}",
                          flush=True)
                if (mgr is not None and p.ckpt_every
                        and old // p.ckpt_every != n // p.ckpt_every):
                    save(n)
                    saved = n
            loader.before_first()
            eval_valid(epoch)
        if loss is None:
            print("dmlc-train: no batches in input", file=sys.stderr)
            return 3
        print(f"trained {p.model}: {n} steps, final loss {float(loss):.5f}",
              flush=True)
        stages.mark("steps")
        if p.eval_auc and p.task == "binary":
            hist: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            with torch.no_grad():
                for batch in loader:
                    a, b = streaming_auc(model(batch), batch["labels"],
                                         batch["weights"])
                    hist = (a, b) if hist is None else (hist[0] + a,
                                                        hist[1] + b)
            print(f"train AUC {float(auc_from_histograms(*hist)):.4f}",
                  flush=True)
            stages.mark("train auc")
    finally:
        loader.close()
    if mgr is not None:
        if saved != n:
            save(n)
        print(f"checkpoint step {n} -> {p.ckpt_dir}", flush=True)
        stages.mark("checkpoint")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print(TrainParams.doc_string())
        return 0
    p = TrainParams()
    try:
        p.init(_parse_argv(argv))
    except (DMLCError, OSError) as e:   # ParamError is a DMLCError; so is
        # a malformed config file
        print(f"dmlc-train: {e}", file=sys.stderr)
        return 2
    why = _refusal(p)
    if why:
        print(f"dmlc-train: {why}", file=sys.stderr)
        return 2
    from .. import native
    from ..kernels import build
    from ..utils.device import resolve_device
    stages = _Stages()
    try:
        device = resolve_device(p.device)
        gen = torch.Generator(device=device).manual_seed(p.seed)
        model = MODEL_REGISTRY[p.model](p, device, gen)
        stages.mark("setup")
        if device.type == "cuda":
            build.build_all()           # a no-op when every kernel is fresh
            stages.mark("kernel build check")
        native.available()
        stages.mark("native build check")
        if p.mode == "predict":
            rc = _predict(p, model, device, stages)
        else:
            rc = _train(p, model, device, stages)
        stages.report()
        return rc
    except DMLCError as e:
        print(f"dmlc-train: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
