"""Container-granularity YARN supervision over the RM REST API.

The reference ships a custom Java ApplicationMaster whose failure policy is
(reference ``tracker/yarn/src/main/java/org/apache/hadoop/yarn/dmlc/
ApplicationMaster.java:535-563``): when a container completes abnormally,
count the failure against its node (blacklist the node past a threshold),
re-request a replacement container for THAT task only, and abort the whole
job once a task exceeds ``maxNumAttempt`` (`:73-74`, abort `:508`).

Re-requesting containers inside a running application needs the AM↔RM
protobuf protocol (what the Java AM links against).  The
re-expression here keeps the same failure domain without any Java: **one
single-container application per task**, driven entirely through the RM
REST API (``/ws/v1/cluster/apps``).  An "application" here is exactly one
container (the AM container runs the task command itself — YARN's
AM-only-app pattern), so

* container death        == one app finishing FAILED → resubmit ONLY that
  task's app with ``DMLC_NUM_ATTEMPT`` bumped (the stable task id flips the
  rabit client into ``recover``, same as every other launcher);
* node blacklisting      == supervisor-side failure counts per node
  (from the report's ``amHostHttpAddress``); blacklisted nodes ride
  ``DMLC_BLACKLISTED_NODES`` into the wrapper, which fails fast when it
  lands on one (YARN then places the retry elsewhere — REST submissions
  cannot carry an explicit node blacklist, so the wrapper enforces it),
  and ``am-black-listing-requests`` turns on YARN's own AM blacklisting;
* abort-after-max        == one task exhausting ``max_attempts`` kills
  every still-running task app and fails the job (reference ``:508``).

The decision logic lives in :class:`TaskSupervisor`, dependency-injected
over :class:`YarnRestClient` so tests drive it against a fake RM
(tests/test_launchers.py) — a container death is proven to retry without
touching the other tasks' applications.

Counterpart of ``dmlc_core_tpu/parallel/launcher/yarn_am.py``, copied as
it is.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional

from ...utils.logging import DMLCError, log_info, log_warning
from ...utils.parameter import env_int, get_env

__all__ = ["YarnRestClient", "TaskSpec", "TaskSupervisor"]

_FINAL_STATES = {"FINISHED", "FAILED", "KILLED"}


class YarnRestClient:
    """Thin JSON client for the RM's app lifecycle REST endpoints."""

    def __init__(self, rm_http: str, timeout: float = 10.0) -> None:
        if not rm_http:
            raise DMLCError("yarn REST mode needs DMLC_YARN_RM_HTTP "
                            "(http://rm-host:8088)")
        self.rm = rm_http.rstrip("/")
        self.timeout = timeout

    def _req(self, method: str, path: str,
             payload: Optional[dict] = None) -> dict:
        import urllib.request
        body = json.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(
            f"{self.rm}{path}", data=body, method=method,
            headers={"Content-Type": "application/json"} if body else {})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            data = r.read()
        return json.loads(data.decode()) if data.strip() else {}

    def new_application(self) -> str:
        out = self._req("POST", "/ws/v1/cluster/apps/new-application")
        app_id = out.get("application-id", "")
        if not app_id:
            raise DMLCError(f"new-application returned no id: {out}")
        return app_id

    def submit(self, payload: dict) -> None:
        self._req("POST", "/ws/v1/cluster/apps", payload)

    def report(self, app_id: str) -> dict:
        return self._req("GET", f"/ws/v1/cluster/apps/{app_id}").get(
            "app", {}) or {}

    def kill(self, app_id: str) -> None:
        try:
            self._req("PUT", f"/ws/v1/cluster/apps/{app_id}/state",
                      {"state": "KILLED"})
        except Exception as e:  # noqa: BLE001 — best-effort teardown
            log_warning("yarn: kill %s failed (%s)", app_id, e)


class TaskSpec:
    """One task == one single-container application."""

    def __init__(self, task_id: int, command: str,
                 env: Optional[Dict[str, str]] = None,
                 memory_mb: int = 1024, vcores: int = 1,
                 queue: str = "", name: str = "") -> None:
        self.task_id = task_id
        self.command = command
        self.env = dict(env or {})
        self.memory_mb = memory_mb
        self.vcores = vcores
        self.queue = queue
        self.name = name or f"dmlc-task-{task_id}"


def _node_of(report: dict) -> str:
    """Node a finished app's (only) container ran on: host part of
    ``amHostHttpAddress`` (the AM container IS the task container)."""
    host = report.get("amHostHttpAddress", "") or report.get("amHost", "")
    return host.split(":")[0]


class TaskSupervisor:
    """The reference AM's failure policy over per-task REST applications.

    Parameters mirror the Java AM's knobs: ``max_attempts`` ==
    ``DMLC_MAX_ATTEMPT`` (`ApplicationMaster.java:73`), ``node_fail_limit``
    == the per-node blacklist threshold (`:74` maxFailedOnNode).  ``sleep``
    is injectable so the fake-RM test runs in milliseconds.
    """

    def __init__(self, client: YarnRestClient, tasks: List[TaskSpec], *,
                 max_attempts: int = 3, node_fail_limit: int = 3,
                 poll_s: float = 2.0,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        self.client = client
        self.tasks = {t.task_id: t for t in tasks}
        self.max_attempts = max(1, int(max_attempts))
        self.node_fail_limit = max(1, int(node_fail_limit))
        self.poll_s = poll_s
        self.sleep = sleep
        self.attempts: Dict[int, int] = {t.task_id: 0 for t in tasks}
        self.app_of: Dict[int, str] = {}          # running task -> app id
        self.done: Dict[int, str] = {}            # task -> final app id
        self.node_failures: Dict[str, int] = {}
        self.blacklist: set = set()
        self.submitted_payloads: List[dict] = []  # telemetry/testability
        self._pending_submit: List[int] = []      # tasks awaiting (re)submit
        self._reserved_app: Dict[int, str] = {}   # task -> unconfirmed app id

    # -- submission -------------------------------------------------------
    def _payload(self, t: TaskSpec, app_id: str) -> dict:
        env = dict(t.env)
        env["DMLC_TASK_ID"] = str(t.task_id)
        env["DMLC_NUM_ATTEMPT"] = str(self.attempts[t.task_id])
        env["DMLC_MAX_ATTEMPT"] = str(self.max_attempts)
        if self.blacklist:
            env["DMLC_BLACKLISTED_NODES"] = ",".join(sorted(self.blacklist))
        p = {
            "application-id": app_id,
            "application-name": t.name,
            "application-type": "DMLC",
            "am-container-spec": {
                "commands": {"command": t.command},
                "environment": {"entry": [
                    {"key": k, "value": v} for k, v in sorted(env.items())]},
            },
            "resource": {"memory": t.memory_mb, "vCores": t.vcores},
            # the app-attempt layer retries AM (==container) crashes YARN-
            # side too; the supervisor still counts/aborts at task level
            "max-app-attempts": 1,
            "am-black-listing-requests": {
                "am-black-listing-enabled": True,
                "disable-failure-threshold": 0.5},
        }
        if t.queue:
            p["queue"] = t.queue
        return p

    def _submit_task(self, t: TaskSpec) -> None:
        """Submit (or resubmit) one task's app.  A transient RM error must
        not crash the supervisor mid-job (the RM REST endpoint blips
        during failovers; ``rm_app_report`` degrades the same way): the
        task parks in ``_pending_submit`` and retries next poll tick.

        The app id is reserved BEFORE the submit and remembered across
        retries: a submit whose RESPONSE is lost (RM accepted, our read
        timed out) must not resubmit under a fresh id — that launches the
        same task twice, with the first copy running unsupervised.  On
        retry we first ask the RM whether the reserved id already exists
        and adopt it if so."""
        try:
            app_id = self._reserved_app.get(t.task_id)
            if app_id is None:
                app_id = self.client.new_application()
                self._reserved_app[t.task_id] = app_id
            else:
                try:
                    landed = bool(self.client.report(app_id).get("state"))
                except Exception:  # noqa: BLE001 — RM has no such app
                    landed = False
                if landed:
                    log_info("yarn: task %d submit of %s had landed — "
                             "adopting, not resubmitting", t.task_id, app_id)
                    self._reserved_app.pop(t.task_id, None)
                    self.app_of[t.task_id] = app_id
                    return
            payload = self._payload(t, app_id)
            self.client.submit(payload)
        except Exception as e:  # noqa: BLE001 — RM blip, retry next tick
            log_warning("yarn: submit of task %d failed (%s: %s) — "
                        "will retry", t.task_id, type(e).__name__, e)
            if t.task_id not in self._pending_submit:
                self._pending_submit.append(t.task_id)
            return
        self._reserved_app.pop(t.task_id, None)
        self.submitted_payloads.append(payload)
        self.app_of[t.task_id] = app_id
        log_info("yarn: task %d attempt %d → %s", t.task_id,
                 self.attempts[t.task_id], app_id)

    # -- failure policy (ApplicationMaster.java:535-563) ------------------
    def _on_failure(self, task_id: int, report: dict) -> bool:
        """Count, blacklist, retry-or-abort.  Returns False to abort."""
        node = _node_of(report)
        if node:
            n = self.node_failures[node] = self.node_failures.get(node, 0) + 1
            if n >= self.node_fail_limit and node not in self.blacklist:
                self.blacklist.add(node)
                log_warning("yarn: node %s blacklisted after %d failures",
                            node, n)
        self.attempts[task_id] += 1
        diag = (report.get("diagnostics") or "").strip()[:300]
        log_warning("yarn: task %d failed on %s (attempt %d/%d)%s",
                    task_id, node or "?", self.attempts[task_id],
                    self.max_attempts, f": {diag}" if diag else "")
        if self.attempts[task_id] >= self.max_attempts:
            # reference aborts the whole job when one task exhausts its
            # attempts (`:508` onCompleted(FAILED) path)
            log_warning("yarn: task %d exceeded max attempts — aborting job",
                        task_id)
            return False
        self._submit_task(self.tasks[task_id])
        return True

    def _abort(self) -> None:
        for tid, app_id in list(self.app_of.items()):
            log_info("yarn: killing task %d (%s)", tid, app_id)
            self.client.kill(app_id)
        self.app_of.clear()

    # -- main loop --------------------------------------------------------
    def run(self) -> int:
        """Submit every task, supervise to completion.  0 iff all tasks'
        apps finish SUCCEEDED; 1 on abort (a task over max_attempts).
        Transient RM REST errors (poll or submit) degrade to a warning
        and a retry next tick — a supervisor that dies on an RM blip
        would orphan every running app unsupervised."""
        for t in self.tasks.values():
            self._submit_task(t)
        while self.app_of or self._pending_submit:
            for task_id in self._pending_submit[:]:
                self._pending_submit.remove(task_id)
                self._submit_task(self.tasks[task_id])
            for task_id, app_id in list(self.app_of.items()):
                try:
                    report = self.client.report(app_id)
                except Exception as e:  # noqa: BLE001 — RM blip
                    log_warning("yarn: poll of %s failed (%s: %s) — "
                                "retrying next tick", app_id,
                                type(e).__name__, e)
                    continue
                state = report.get("state", "")
                if state not in _FINAL_STATES:
                    continue
                del self.app_of[task_id]
                if (state == "FINISHED"
                        and report.get("finalStatus") == "SUCCEEDED"):
                    self.done[task_id] = app_id
                    log_info("yarn: task %d finished (%s)", task_id, app_id)
                elif state == "KILLED":
                    # only _abort() kills our apps, and it never returns to
                    # this loop — so KILLED means an operator/preemption
                    # outside the supervisor.  That is job-level intent,
                    # not a container fault: abort without counting a node
                    # failure (a kill must not blacklist a healthy node)
                    log_warning("yarn: task %d app %s killed externally — "
                                "aborting job", task_id, app_id)
                    self._abort()
                    return 1
                elif not self._on_failure(task_id, report):
                    self._abort()
                    return 1
            if self.app_of or self._pending_submit:
                self.sleep(self.poll_s)
        return 0


def supervise_from_args(args, tracker_envs: Dict[str, str]) -> int:
    """Entry used by submit_yarn's REST mode: build per-task specs from the
    launcher args (same wrapper body as every backend, shipped inline via
    base64 — REST submissions have no file cache) and run the supervisor."""
    import base64

    from .wrapper import wrapper_body

    # task id arrives via env (the supervisor sets it per app); the rank
    # snippet just re-exports it so the shared wrapper's validation runs
    body = wrapper_body(args, tracker_envs, "yarn",
                        'export DMLC_TASK_ID="${DMLC_TASK_ID}"',
                        stage_mode="copy")
    blob = base64.b64encode(body.encode()).decode()
    command = (f"echo {blob} | base64 -d > dmlc_task.sh && "
               f"exec bash dmlc_task.sh")
    nproc = args.num_workers + args.num_servers
    tasks = [TaskSpec(
        i, command,
        memory_mb=(args.server_memory_mb if i < args.num_servers
                   else args.worker_memory_mb),
        vcores=(args.server_cores if i < args.num_servers
                else args.worker_cores),
        queue=getattr(args, "yarn_queue", "") or "",
        name=f"{args.jobname or 'dmlc'}-task{i}") for i in range(nproc)]
    client = YarnRestClient(get_env("DMLC_YARN_RM_HTTP", ""))
    sup = TaskSupervisor(
        client, tasks,
        max_attempts=max(1, getattr(args, "max_attempts", 1)),
        node_fail_limit=env_int("DMLC_YARN_NODE_FAIL_LIMIT", 3,
                                minimum=1))
    return sup.run()
