"""``dmlc-train`` of the port: config-file-driven training on the card.

Counterpart of ``dmlc_core_tpu/models/cli.py``, run as

    python -m dmlc_core_tpu_torch.models.cli train.conf model=deepfm data=train.libsvm

with the same ``TrainParams`` keys and defaults, the same ``key=value``
and config-file grammar (CLI pairs override the file; unknown keys and
bad values fail before any data is read) and the same printed lines.
One key more: ``device`` (``cuda``, or ``cpu`` for the plain PyTorch
path), the counterpart of ``JAX_PLATFORMS``; it is never read from the
environment, and without a card ``device=cuda`` exits 2.

It trains on the flat layout, through ``DeviceLoader(create_parser(data,
format), batch_rows, nnz_cap, id_mod=features, fields=model == "ffm")``
(the threaded native parser and the native packer wherever g++ exists,
as the JAX CLI's loader; libsvm, libfm or csv, resolved as the JAX CLI
resolves them: ``format=``, ``model=ffm`` implies libfm, then a
``?format=`` argument of ``data``, then the file suffix, then libsvm;
csv's ``?label_column=&delimiter=`` ride on the URI).  ``data=``,
``valid=`` and predict's ``data=`` take what the JAX CLI takes: a local
path or a URI of any registered scheme (``s3://``, ``hdfs://``,
``http://``, ...; the environment variables of
:mod:`..io.remote_filesys`), of a file, a directory (read recursively;
on an object store, a key prefix), a ``;`` list or a local ``*``/``?``
glob, and a ``#cachefile`` fragment (a local file): the raw-chunk cache of
the split and, on the fused path (every model but ``ffm``), the loader's
packed-page cache at ``<cachefile>.pages``, from which the epochs after
the first are served without parsing or packing.  Predict reads its
input uncached: a cached epoch counts no rows, and the scores are
trimmed to the rows read.  Training uses
``optax.adam``'s update (``models.train.adam``, the port's fused Adam).
With ``kstep > 1`` (ignored for ``model=ffm``, whose fields the fused
wire does not carry) the loader emits the fused wire's host buffers and
:class:`.train.FusedTrainer` runs ``kstep`` steps a dispatch (one CUDA
graph replay on the card); logging and checkpoints then fire at group
granularity, as in the JAX CLI, and the end-of-run AUC reads a fresh
device-emitting loader over the same file.  A checkpoint holds
``params`` (the JAX param tree) and ``opt_state`` in ``optax.adam``'s
layout (:func:`.convert.adam_state_to_optax`), so either package's
``resume`` and ``mode=predict`` read the other's checkpoints.
``ckpt_dir=`` may be local or remote, and predict writes ``output=``
through the I/O layer's ``open_stream``, so any writable scheme works
as the sink.
``ckpt_every`` saves with ``CheckpointManager.save_async`` (a snapshot
of the parameters and moments on the card, written on a thread while
training goes on), and the run waits for it before the final,
synchronous save, as the JAX CLI does; a failed background save is
printed and the run exits 2.
At the end of a run one line on stderr gives the host-clock seconds of
its stages from ``main`` on: set-up, the kernel and native build checks,
the optimizer's set-up (or a resume), the wait for the first batch, the
steps, validation, the train AUC and the checkpoint (or, to predict, the
scoring).

``workers=host:port,...`` trains from ingest workers
(``python -m dmlc_core_tpu_torch.pipeline.ingest_service``, one
partition each) through :class:`..pipeline.RemoteIngestLoader` in place
of ``data=``, emitting host frames for ``kstep > 1``.  Validation and
predict read ``valid=`` and ``data=`` locally; the end-of-run AUC reads
the workers once more (a ``kstep`` run through a device-emitting
loader), as in the JAX CLI.  ``model=ffm`` with ``workers=`` exits 2:
the fused wire carries no fields.
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


@MODEL_REGISTRY.register("ffm", "field-aware FM (libfm fields)")
def _ffm(p: "TrainParams", device: torch.device,
         generator: torch.Generator):
    from .ffm import FieldAwareFM
    return FieldAwareFM(num_features=p.features, num_fields=p.fields,
                        dim=p.dim, l2=p.l2, task=p.task, device=device,
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
                   help="predictions file URI (predict mode)")
    workers = field(str, default="",
                    help="comma-separated host:port ingest workers "
                         "(disaggregated ingest; train mode, fused "
                         "formats only)")
    valid = field(str, default="",
                  help="validation data URI: accuracy/AUC printed per "
                       "epoch (the reference ecosystem's watchlist)")
    format = field(str, default="auto",
                   enum=["auto", "libsvm", "libfm", "csv"],
                   help="input format ('auto': ?format= URI arg, then file "
                        "suffix .libsvm/.libfm/.csv, then libsvm; ffm "
                        "implies libfm)")
    # lazy enum: registering a model is the only step to join the CLI
    model = field(str, default="fm",
                  enum=lambda: sorted(MODEL_REGISTRY.list_names()),
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
                            "end); saved asynchronously")
    resume = field(bool, default=False,
                   help="continue from the latest checkpoint in ckpt_dir "
                        "(params and optimizer state; either package's)")
    eval_auc = field(bool, default=True,
                     help="streaming AUC over the train stream at the end")
    kstep = field(int, default=1, lower_bound=1,
                  help="train steps fused per device dispatch (>1: the "
                       "k-step trainer, one CUDA graph replay a group); "
                       "ignored for ffm (fields ride outside the fused "
                       "wire)")
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


def _resolve_format(p: TrainParams) -> str:
    """The JAX CLI's rule: ``format=``, else libfm for ``model=ffm``,
    else a ``?format=`` URI argument, else the file suffix, else
    libsvm."""
    if p.format != "auto":
        return p.format
    if p.model == "ffm":
        return "libfm"
    for arg in p.data.partition("?")[2].split("&"):
        if arg.startswith("format="):
            return arg[len("format="):]
    base = p.data.split("?", 1)[0].rstrip("/")
    for suf in ("libsvm", "libfm", "csv"):
        if base.endswith("." + suf):
            return suf
    return "libsvm"


def _refusal(p: TrainParams) -> Optional[str]:
    """Why ``p`` cannot run, before any data is read, or None."""
    if not p.workers:
        return None
    if p.model == "ffm":
        return ("workers= (fused wire) does not carry libfm fields — use "
                "local ingest for ffm")
    try:
        _worker_addresses(p)
    except ValueError:
        return (f"workers= expects host:port[,host:port...], got "
                f"{p.workers!r}")
    return None


def _worker_addresses(p: TrainParams) -> List[Tuple[str, int]]:
    addrs = []
    for tok in p.workers.split(","):
        host, _, port = tok.strip().rpartition(":")
        if not host:
            raise ValueError(tok)
        addrs.append((host, int(port)))
    return addrs


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


def _make_loader(p: TrainParams, uri: str, device: torch.device,
                 emit: str = "device", cache="auto"):
    """The one place a run's local loader is configured: train,
    validation, end-of-run AUC and predict all see the same format, batch
    shape, fields and hashing."""
    from ..data import create_parser
    from ..pipeline import DeviceLoader
    return DeviceLoader(create_parser(uri, 0, 1, _resolve_format(p)),
                        batch_rows=p.batch_rows, nnz_cap=p.nnz_cap,
                        id_mod=p.features, device=device, emit=emit,
                        fields=p.model == "ffm", cache=cache)


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
    ``p.output`` (text, '%.6f\\n'; sigmoid for binary task) through the
    I/O layer, so any registered scheme is a sink."""
    from ..io import open_stream
    from ..utils.checkpoint import CheckpointManager

    if not p.ckpt_dir or not p.output:
        print("dmlc-train: predict mode needs ckpt_dir and output",
              file=sys.stderr)
        return 2
    mgr = CheckpointManager(p.ckpt_dir)
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
    # a cached epoch packs nothing, so it counts no rows: read uncached
    loader = _make_loader(p, p.data, device, cache=None)
    try:
        with open_stream(p.output, "w") as out, torch.no_grad():
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
        start_n, state = CheckpointManager(p.ckpt_dir).restore()
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
    from .convert import adam_state_to_optax, params_tree
    from .train import (FusedTrainer, adam, auc_from_histograms,
                        evaluate_stream, make_train_step, streaming_auc)

    if p.resume and not p.ckpt_dir:
        print("dmlc-train: resume=true needs ckpt_dir", file=sys.stderr)
        return 2
    if p.ckpt_every and not p.ckpt_dir:
        # a long job silently writing no checkpoint is unrecoverable
        print("dmlc-train: ckpt_every needs ckpt_dir", file=sys.stderr)
        return 2
    opt = adam(model, p.lr)
    # loaded in place, before any graph captures the tensors' addresses
    start_n = _resume(p, model, opt, device) if p.resume else 0
    fused = p.kstep > 1 and p.model != "ffm"
    if p.kstep > 1 and not fused:
        log_info("dmlc-train: kstep=%d ignored for model=ffm (the fused "
                 "wire carries no fields); one step a batch", p.kstep)
    step = None if fused else make_train_step(model, opt)
    mgr = CheckpointManager(p.ckpt_dir) if p.ckpt_dir else None
    stages.mark("optimizer set-up")

    def state():
        # the tensors themselves: save streams them from the card and
        # save_async snapshots them there
        return {"params": params_tree(model),
                "opt_state": adam_state_to_optax(model, opt, host=False)}

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

    def after_steps(epoch: int, new_n: int, get_loss) -> None:
        """Log and checkpoint cadence of both loops; with kstep the step
        count jumps a group at a time and each boundary fires once per
        crossed multiple (the JAX CLI's group granularity)."""
        nonlocal n, saved
        old, n = n, new_n
        if p.log_every and old // p.log_every != n // p.log_every:
            print(f"epoch {epoch} step {n} loss {float(get_loss()):.5f}",
                  flush=True)
        if (mgr is not None and p.ckpt_every
                and old // p.ckpt_every != n // p.ckpt_every):
            t = time.perf_counter()
            mgr.save_async(n, state(), meta={"model": p.model,
                                             "steps": int(n)})
            log_info("checkpoint: save_async of step %d returned in %.3f s "
                     "(host clock)", n, time.perf_counter() - t)
            saved = n

    emit = "host" if fused else "device"
    if p.workers:
        from ..pipeline import RemoteIngestLoader
        loader = RemoteIngestLoader(_worker_addresses(p),
                                    batch_rows=p.batch_rows, emit=emit,
                                    device=device)
    else:
        loader = _make_loader(p, p.data, device, emit=emit)
    trainer = FusedTrainer(model, opt, loader, k=p.kstep) if fused else None

    def sync(epoch: int) -> None:
        if start_n + trainer.steps != n:
            after_steps(epoch, start_n + trainer.steps,
                        lambda: trainer.losses[-1])

    first = True
    try:
        for epoch in range(p.epochs):
            for item in loader:
                if first:
                    stages.mark("first batch")
                    first = False
                if trainer is not None:
                    trainer.feed(item)
                    sync(epoch)
                else:
                    loss = step(item)
                    after_steps(epoch, n + 1, lambda: loss)
            if trainer is not None:
                trainer.flush()
                sync(epoch)
                if trainer.losses is not None:
                    loss = trainer.losses[-1]
            loader.before_first()
            eval_valid(epoch)
        if loss is None:
            print("dmlc-train: no batches in input", file=sys.stderr)
            return 3
        print(f"trained {p.model}: {n} steps, final loss {float(loss):.5f}",
              flush=True)
        stages.mark("steps")
        if p.eval_auc and p.task == "binary":
            # the train loader of kstep emits host buffers: score through
            # a fresh device-emitting loader over the same source (the
            # workers, whose data= may be readable on their hosts only)
            if not fused:
                auc_loader = loader
            elif p.workers:
                from ..pipeline import RemoteIngestLoader
                auc_loader = RemoteIngestLoader(_worker_addresses(p),
                                                batch_rows=p.batch_rows,
                                                device=device)
            else:
                auc_loader = _make_loader(p, p.data, device)
            hist: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            try:
                with torch.no_grad():
                    for batch in auc_loader:
                        a, b = streaming_auc(model(batch), batch["labels"],
                                             batch["weights"])
                        hist = (a, b) if hist is None else (hist[0] + a,
                                                            hist[1] + b)
            finally:
                if auc_loader is not loader:
                    auc_loader.close()
            print(f"train AUC {float(auc_from_histograms(*hist)):.4f}",
                  flush=True)
            stages.mark("train auc")
    finally:
        loader.close()
        failed = None
        if mgr is not None:
            # the save in flight is waited for even when the loop raised:
            # the last published checkpoint is what a resume needs
            try:
                mgr.wait()
            except DMLCError as e:
                failed = e
                print(f"dmlc-train: background checkpoint failed: {e}",
                      file=sys.stderr)
    if mgr is not None:
        stages.mark("checkpoint wait")
        if saved != n:
            mgr.save(n, state(), meta={"model": p.model, "steps": int(n)})
        print(f"checkpoint step {n} -> {p.ckpt_dir}", flush=True)
        stages.mark("checkpoint")
    return 2 if failed is not None else 0


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
        if device.type == "cuda":
            log_info("dmlc-train peak card memory %.3f GB "
                     "(max_memory_allocated)",
                     torch.cuda.max_memory_allocated(device) / 1e9)
        return rc
    except DMLCError as e:
        print(f"dmlc-train: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
