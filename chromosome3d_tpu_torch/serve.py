"""Warm-model serving — the port of chromosome3d_tpu/serve.py.

A long-lived server solves many matrices over time and keeps what a solve
builds once warm across requests. Transport is a Unix domain socket with
newline-delimited JSON (no TCP). The server is THREADED: each connection
gets a handler thread, control requests (ping/shutdown) answer immediately,
and device work is serialized through one lock, so a first request that
builds the kernels never blocks a ping, and two solves never interleave on
the device. Protocol (the JAX package's):

  request:  {"matrix": "/path/to/if_matrix.txt", "out": "/path/out",
             "alpha": 0.5, "kscaling": 11.0, "models": 10,
             "turbo": true}
            {"restraints": "/path/to/file.rr|.tbl", "out": "/path/out",
             "models": 10, "turbo": true, "L": 456}
  response: {"ok": true, "summary": {...}}   |   {"ok": false, "error": "..."}
  control:  {"cmd": "ping"} -> {"ok": true, "pong": true, "warm_buckets": [...],
             "busy": <solves in flight or waiting>}
            {"cmd": "shutdown"} -> server exits after responding

Request bounds (rejected with ok=false, never crashing the server):
models 1..MAX_MODELS, 0 < alpha <= MAX_ALPHA, 0 < kscaling <= MAX_KSCALING,
1 < L <= MAX_L, input paths must exist; at most MAX_QUEUE solves in flight
or waiting.

What "warm" means here: the first solve builds and loads the kernels'
library (ops._build.load_library, cached for the life of the process; the
JAX server's first request compiles its programs the same way), and the
CUDA context, the caching allocator's blocks and the kernels' workspaces
(ops._build.workspace) stay up across requests. Nothing else is held: the
solver builds its schedule table inside itself and takes no argument that
depends only on the bucket and the config (the bead mask depends on L), so
the cache keeps no solve object, only the warm set `ping` reports,
(L_pad, models, total_steps) for each bucket solved.

Every launch of a served solve runs under SolverCache.device_lock: the
solve, the on-device restraint prep, the assessment view's re-prep and the
first request's library build. The kernels' workspaces (one a device and
kernel) assume that launches never overlap, and no handler thread makes a
stream of its own. The artifacts are written outside the lock, from host
arrays only.

The server computes on one device, the first CUDA device unless the CPU is
asked for (device.resolve_device); a server asked for CUDA on a machine
without it raises at start. torch and the solver are imported inside
SolverCache, so a client (`request`, the CLI's `submit`) imports neither.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import socketserver
import threading
from typing import Dict, Optional

from chromosome3d_tpu_torch.config import PipelineConfig, turbo_anneal
from chromosome3d_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

# request caps: generous for real workloads, small enough that a typo'd or
# hostile request cannot exhaust the device or queue hours of work
MAX_MODELS = 256
MAX_L = 65536
MAX_ALPHA = 16.0
MAX_KSCALING = 1e6
# solves in flight or waiting on the device lock before new ones are
# rejected: bounds the queue a runaway client can build up
MAX_QUEUE = 32


class SolverCache:
    """Routes every request through the padded bucket shapes the pipeline
    uses and records the buckets solved (the warm set ping reports).
    device_lock serializes everything that touches the device: handler
    threads answer control requests concurrently, but solves queue."""

    def __init__(self, base: Optional[PipelineConfig] = None, device=None):
        from chromosome3d_tpu_torch.device import resolve_device

        self.base = base or PipelineConfig()
        self.device = resolve_device(device)
        self.warm: set = set()
        self.device_lock = threading.Lock()
        self.busy = 0               # solves holding or waiting on the lock
        self._busy_lock = threading.Lock()

    def bucket_for(self, L: int) -> int:
        fit = [b for b in self.base.length_buckets if b >= L]
        if fit:
            return min(fit)
        if self.base.shard_large:
            from chromosome3d_tpu_torch.pipeline import quantum_bucket

            return quantum_bucket(L, self.base.shard_quantum)
        raise ValueError(
            f"L={L} exceeds the largest bucket {max(self.base.length_buckets)}"
        )

    def add_warm(self, L_pad: int, cfg: PipelineConfig) -> None:
        with self._busy_lock:   # guards warm against ping's iteration
            self.warm.add((L_pad, cfg.model_count, cfg.anneal.total_steps))

    def warm_snapshot(self):
        with self._busy_lock:
            return sorted(self.warm)

    def solve(self, matrix, cfg: PipelineConfig):
        """Solve one chromosome through the padded path, as run_pipeline
        does; returns (coords (n, L, 3), energies dict, host Restraints
        view, and an assessment-ready exact view or None), all host numpy,
        padding stripped. Caller must hold device_lock.

        Within the buckets: the host restraints (build_restraints), the
        padded tensors on the device and solve_ensemble_impl (kernels B1 and
        B2 on the fused route). Past them, with exact restraints provable:
        the prep on the device from the padded IF matrix (streamed where
        device_prep.should_stream_prep says so), no host restraint pass, and
        after the solve the host views rebuilt on the device and
        downloaded. Row-sharded where pipeline._use_sharded says so (the
        padded length recorded is the one solved). Under pair_bf16 the
        prep stores the solve's tiles as bfloat16, and the views are
        prepped at float32 after those are freed. The draws come from a
        generator seeded cfg.seed, as run_pipeline's, so a served request
        writes what `run` writes on the same matrix and config."""
        from chromosome3d_tpu_torch.utils import trace

        with trace.request():
            return self._solve(matrix, cfg)

    def _solve(self, matrix, cfg: PipelineConfig):
        import numpy as np

        from chromosome3d_tpu_torch import device as device_mod
        from chromosome3d_tpu_torch import pipeline as pl
        from chromosome3d_tpu_torch.ops import device_prep
        from chromosome3d_tpu_torch.parallel.shards import ShardGroup
        from chromosome3d_tpu_torch.restraints import build_restraints
        from chromosome3d_tpu_torch.solver.sharded import restraint_strips
        from chromosome3d_tpu_torch.utils import trace

        L = matrix.shape[0]
        rc = cfg.restraints
        device_route = L > max(cfg.length_buckets) and pl._exact_provable(
            pl.auto_exact_matrix(cfg)
        )
        if device_route:
            cfg = pl.auto_exact_matrix(cfg)
            r = None
        else:
            r = build_restraints(matrix, rc)
            cfg = pl.auto_exact(cfg, r)  # matrix-derived restraints: exact routes
        exact = pl._exact_provable(cfg)
        dev, group = self.device, None
        if pl._use_sharded(L, cfg, dev, exact, device_route):
            group = ShardGroup(device_mod.shard_devices())
            dev = group.lead
            L_pad, bead_mask = pl._shard_pad(L, cfg, group)
        else:
            L_pad = self.bucket_for(L)
            pl._refuse_past_memory(L_pad, cfg, exact, dev, device_route)
            bead_mask = None
            if L_pad != L:
                bead_mask = (np.arange(L_pad) < L).astype(np.float32)
        if device_route:
            # padded once: the solve's prep and the assessment view read it
            if_dev = device_prep.pad_f32(matrix, L_pad)
            # pair_bf16: the solve's tiles stored bf16; the assessment view
            # below is a float32 prep of its own
            solve_r = device_prep.exact_tiles_from_if_device(
                if_dev, L_pad, rc, rc.weighting, pl._weight_exponent(rc, L),
                n_true=L, device=dev, group=group,
                out_dtype=pl.solve_tile_dtype(cfg, True),
            )
        else:
            solve_r = pl._padded_dense(r, rc, L_pad, exact, dev)
            if group is not None:
                solve_r = restraint_strips(group, solve_r)
        result = pl._solve(group, solve_r, cfg, bead_mask, dev)
        self.add_warm(L_pad, cfg)
        coords = trace.to_host(result.coords).numpy()[:, :L, :]   # synchronises
        energies = {k: trace.to_host(v).numpy() for k, v in result.energies.items()}
        # the downloads above fenced the solve: free its tiles BEFORE the
        # assessment re-prep below allocates its own, so the two tile sets
        # never coexist at the device's peak (run_pipeline's order)
        solve_r = result = None
        dense_view = None
        if device_route:
            r, dense_view = pl._assessment_view_from_if(if_dev, rc, L_pad, L, dev)
        return coords, energies, r, dense_view


def _validate(req: Dict, cache: SolverCache) -> Optional[str]:
    """Bounds-check a solve request; returns an error string or None."""
    try:
        models = int(req.get("models", cache.base.model_count))
        if not 1 <= models <= MAX_MODELS:
            return f"models={models} out of bounds [1, {MAX_MODELS}]"
        alpha = float(req.get("alpha", cache.base.restraints.alpha))
        if not 0.0 < alpha <= MAX_ALPHA:
            return f"alpha={alpha} out of bounds (0, {MAX_ALPHA}]"
        k = float(req.get("kscaling", cache.base.restraints.kscaling))
        if not 0.0 < k <= MAX_KSCALING:
            return f"kscaling={k} out of bounds (0, {MAX_KSCALING}]"
        if "L" in req:
            L = int(req["L"])
            if not 1 < L <= MAX_L:
                return f"L={L} out of bounds (1, {MAX_L}]"
        for key in ("matrix", "restraints"):
            if key in req and not os.path.isfile(str(req[key])):
                return f"{key} file {req[key]!r} does not exist"
        if "out" in req and not str(req["out"]).strip():
            return "out must be a non-empty path"
    except (TypeError, ValueError) as e:
        return f"malformed request field: {e}"
    return None


def handle_request(req: Dict, cache: SolverCache) -> Dict:
    if req.get("cmd") == "ping":
        return {
            "ok": True,
            "pong": True,
            "warm_buckets": cache.warm_snapshot(),
            "busy": cache.busy,
        }
    if req.get("cmd"):
        return {"ok": False, "error": f"unknown cmd {req['cmd']!r}"}
    if "restraints" not in req and "matrix" not in req:
        return {"ok": False, "error": "request needs 'matrix' or 'restraints'"}
    if "out" not in req:
        return {"ok": False, "error": "request needs 'out'"}
    err = _validate(req, cache)
    if err:
        return {"ok": False, "error": err}

    # count the request as busy BEFORE the first-request imports below (a
    # fresh process takes a while to import the solver), so a concurrent
    # ping already sees busy >= 1. The queue-depth cap rides the same lock
    # acquisition: check-and-increment is atomic.
    with cache._busy_lock:
        if cache.busy >= MAX_QUEUE:
            return {
                "ok": False,
                "error": f"server busy: {cache.busy} solves in flight or "
                         f"queued (max {MAX_QUEUE})",
            }
        cache.busy += 1
    try:
        from chromosome3d_tpu_torch.io.matrix import load_if_matrix, matrix_length
        from chromosome3d_tpu_torch.ops.energy import dense_restraints_from_numpy
        from chromosome3d_tpu_torch.pipeline import emit_artifacts, run_restraints_pipeline

        if "restraints" in req:
            # solve directly from a .rr / CNS .tbl restraint file (incl.
            # or-groups): the general distance-geometry request
            anneal_r = cache.base.anneal
            if req.get("turbo"):
                anneal_r = turbo_anneal(anneal_r)
            cfg_r = cache.base.replace(
                model_count=int(req.get("models", cache.base.model_count)),
                anneal=anneal_r,
            )
            try:
                with cache.device_lock:
                    # max_L guards the INFERRED length too: a file naming
                    # resid 200000 with no "L" field must be rejected
                    # before tensors are allocated or a solve is queued
                    summary = run_restraints_pipeline(
                        req["restraints"], req["out"], cfg_r,
                        L=int(req["L"]) if "L" in req else None,
                        max_L=MAX_L, device=cache.device,
                    )
            except ValueError as e:
                return {"ok": False, "error": str(e)}
            try:
                # the pipeline reports the padded length it actually solved
                # at (L_solved): record THAT, not the plain quantum bucket
                # (they differ for sharded solves)
                cache.add_warm(int(summary["L_solved"]), cfg_r)
            except (ValueError, KeyError):
                # bookkeeping only: never turn a finished solve into an
                # error response
                pass
            # same wire shape as the matrix route
            return {"ok": True, "summary": summary}

        matrix_path = req["matrix"]
        out_dir = req["out"]
        anneal = cache.base.anneal
        if req.get("turbo"):
            anneal = turbo_anneal(anneal)
        cfg = cache.base.replace(
            model_count=int(req.get("models", cache.base.model_count)),
            # per-request knobs override the server's BASE restraint config;
            # every other field (separation, weighting, weight_exponent, ...)
            # and an absent alpha or kscaling keep the operator's values
            restraints=dataclasses.replace(
                cache.base.restraints,
                kscaling=float(
                    req.get("kscaling", cache.base.restraints.kscaling)
                ),
                alpha=float(req.get("alpha", cache.base.restraints.alpha)),
            ),
            anneal=anneal,
        )
        # bound L from the FIRST ROW before materializing the whole matrix:
        # a typo'd/hostile 200k-square file would otherwise make the server
        # load tens of GB of float64 before the post-load check ran
        L_head = matrix_length(matrix_path)
        if L_head > MAX_L:
            return {"ok": False,
                    "error": f"matrix L={L_head} exceeds {MAX_L}"}
        matrix = load_if_matrix(matrix_path)
        if matrix.shape[0] > MAX_L:
            return {"ok": False,
                    "error": f"matrix L={matrix.shape[0]} exceeds {MAX_L}"}
        with cache.device_lock:
            coords, energies, restraints, dense = cache.solve(matrix, cfg)
        os.makedirs(out_dir, exist_ok=True)
        ident = os.path.basename(matrix_path)
        ident = ident[:-4] if ident.endswith(".txt") else ident
        if dense is None:
            # assessment-only tensors: HOST numpy (emit_artifacts runs
            # outside device_lock and touches nothing on the device)
            dense = dense_restraints_from_numpy(
                restraints, cfg.restraints.weighting,
                cfg.restraints.weight_exponent, as_numpy=True,
            )
        summary = emit_artifacts(
            out_dir, ident, coords, energies, matrix, restraints, dense, cfg
        )
        return {"ok": True, "summary": summary}
    finally:
        with cache._busy_lock:
            cache.busy -= 1


def serve(socket_path: str, cfg: Optional[PipelineConfig] = None, device=None) -> None:
    """Blocking server loop on a Unix domain socket (threaded: one handler
    thread per connection; device work serialized by cache.device_lock).
    device: as device.resolve_device (None is the first CUDA device, and
    raises here, before the socket is bound, where there is none)."""
    cache = SolverCache(cfg, device)
    if os.path.exists(socket_path):
        os.remove(socket_path)

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for line in self.rfile:
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    self._reply({"ok": False, "error": f"bad json: {e}"})
                    continue
                if not isinstance(req, dict):
                    self._reply({"ok": False, "error": "request must be an object"})
                    continue
                if req.get("cmd") == "shutdown":
                    self._reply({"ok": True, "bye": True})
                    # shutdown() must run off the serve_forever thread and
                    # off this handler (it joins the pollers); a daemon
                    # thread unblocks both
                    threading.Thread(
                        target=self.server.shutdown, daemon=True
                    ).start()
                    return
                try:
                    self._reply(handle_request(req, cache))
                except Exception as e:  # report, keep serving
                    log.info(f"request failed: {e!r}")
                    self._reply({"ok": False, "error": repr(e)})

        def _reply(self, obj):
            self.wfile.write((json.dumps(obj) + "\n").encode())
            self.wfile.flush()

    class Server(socketserver.ThreadingUnixStreamServer):
        allow_reuse_address = True
        daemon_threads = True

    log.info(f"serving on {socket_path} ({cache.device})")
    with Server(socket_path, Handler) as server:
        try:
            server.serve_forever()
        finally:
            if os.path.exists(socket_path):
                os.remove(socket_path)


def request(socket_path: str, req: Dict, timeout: float = 600.0) -> Dict:
    """One-shot client: send a request, return the response dict. Retries
    briefly on ConnectionRefused (the server's bind->listen window) with a
    FRESH socket per attempt — POSIX leaves a socket's state unspecified
    after a failed connect, so reusing one can fail with EINVAL."""
    import time as _time

    s = None
    for attempt in range(20):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        try:
            s.connect(socket_path)
            break
        except (ConnectionRefusedError, FileNotFoundError):
            s.close()
            s = None
            if attempt == 19:
                raise
            _time.sleep(0.05)
        except BaseException:
            # any other connect failure (timeout, EPERM, ...): don't leak
            # the per-attempt socket fd on the propagation path
            s.close()
            raise
    try:
        s.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    finally:
        s.close()
    return json.loads(buf.decode())
