"""Benchmark of palace_torch on NVIDIA H100 cards: one run of one cell.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout.  The cell, its configuration, its traffic
mix and its metrics are found by name from BENCHMARK.json (README.md in
this folder).  A run sets up (mesh, assembly, solver hierarchy, kernel
build, one warm-up request), then sends requests in a closed loop with one
client until `--seconds` have passed and the last request has finished,
then compares what the timed path produced with the plain reference, and
prints the result as one JSON line, last on standard output.  With
`--trace 1` the window runs under torch.profiler and the line carries the
per-layer metrics in place of the end-to-end ones.

Exits with a non-zero code, printing no result, where CUDA has fewer
cards than the cell asks for, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(BENCH_DIR)
for _p in (BENCH_DIR, REPO_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def pin_threads(n: int) -> None:
    """Hold the host math libraries to n threads (before numpy loads)."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
                "NUMEXPR_NUM_THREADS"):
        os.environ[var] = str(n)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Run:
    """What the metric readers read: times, spans, counters, the trace."""

    def __init__(self, cell, spans):
        self.cell = cell
        self.spans = spans
        self.setup_s = 0.0
        self.window_t0 = 0.0
        self.window_s = 0.0
        self.requests = []
        self.counters = {}
        self.peak_bytes = 0
        self.trace = None

    def window_totals(self):
        return self.spans.totals(since=self.window_t0)

    def setup_totals(self):
        return self.spans.totals(until=self.window_t0)


def _counters():
    from palace_torch.ops import structured_kernel as sk
    from palace_torch.utils import provenance

    snap = provenance.snapshot()
    return {"kernel1_launches": sk.structured_apply_flat.launches,
            "waveport_mode_seconds": float(
                snap.get("waveport_mode_seconds", 0.0)),
            "waveport_mode_solves": int(snap.get("waveport_mode_solves", 0))}


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = None):
    """Set up, warm up, run the window, judge; returns (result dict, check
    lines).  `device` is the torch device the program runs on."""
    import contextlib
    import shutil
    import tempfile

    import torch

    from harness import cells, trace as tr
    from harness.session import Session
    from harness.spans import PREFIX, Spans
    from harness.traffic import FrequencyStream
    from reference import check

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device.type == "cuda"
    torch.set_num_threads(int(cell.traffic["host_threads"]))
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    spans = Spans(traced=trace)
    run = Run(cell, spans)
    band = cell.config["band_ghz"]
    workdir = tempfile.mkdtemp(prefix="bench_h100_")
    try:
        sess = Session(cell.config, cell.traffic, workdir, device, spans)
        sess.setup()
        # The warm-up request runs the window's shapes: the solver pads a
        # block to its full width, so one frequency suffices.
        warm = FrequencyStream(seed, band, cell.traffic, stream=1)
        sess.request(warm.next_request()[:1], keep=False)
        if cuda:
            torch.cuda.synchronize()
        run.setup_s = time.perf_counter() - t_start
        log(f"setup {run.setup_s:.3f} s")

        stream = FrequencyStream(seed, band, cell.traffic)
        c0 = _counters()
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()
        run.window_t0 = time.perf_counter()
        with torch.profiler.record_function(PREFIX + "window") if trace \
                else contextlib.nullcontext():
            while time.perf_counter() - run.window_t0 < seconds \
                    or not run.requests:
                freqs = stream.next_request()
                try:
                    req = sess.request(freqs, keep=True)
                except Exception as e:  # a failed request is counted
                    from harness.session import Request

                    req = Request(time.perf_counter(), time.perf_counter(),
                                  freqs, error=f"{type(e).__name__}: {e}")
                run.requests.append(req)
            if cuda:
                torch.cuda.synchronize()
        run.window_s = time.perf_counter() - run.window_t0
        if prof is not None:
            prof.__exit__(None, None, None)
        c1 = _counters()
        run.counters = {k: c1[k] - c0[k] for k in c1}
        if cuda:
            run.peak_bytes = int(torch.cuda.max_memory_allocated())
        if prof is not None:
            t_tr = time.perf_counter()
            run.trace = tr.reduce(prof) if cuda else None
            del prof
            log(f"trace reduced in {time.perf_counter() - t_tr:.3f} s")
            if run.trace is not None:
                log(f"device idle s by span {run.trace.idle_by_span}")
                log(f"device busy s by span {run.trace.busy_by_span}")
            for name, (n, secs) in sorted(
                    run.trace.ops.items() if run.trace else (),
                    key=lambda kv: -kv[1][1])[:15]:
                log(f"device op {secs:.6f} s {n} launches {name[:100]}")
        for i, r in enumerate(run.requests):
            parts = spans.totals(since=r.t0, until=r.t1 + 1e-9)
            log(f"request {i} {r.t1 - r.t0:.4f} s its {r.iterations} "
                f"relres {max(r.relres, default=float('nan')):.3e} "
                + " ".join(f"{k} {v[0]:.4f}" for k, v in sorted(parts.items())
                           if k != "request")
                + (f" error {r.error}" if r.error else ""))
        log(f"window {run.window_s:.3f} s, {len(run.requests)} requests, "
            f"counters {run.counters}")

        metrics = cells.read_metrics(cell.metrics(trace), run)
        failed = sum(sess.failed(r) for r in run.requests)

        t_ref = time.perf_counter()
        outputs = sess.program_outputs(run.requests)
        mesh = sess.mesh
        sess.close()
        if cuda:
            torch.cuda.empty_cache()
        nums = check.judge(cell.config, mesh, outputs)
        limits = cell.config["check"]
        correct = check.verdict(nums, limits) and not any(
            r.error for r in run.requests)
        log(f"reference {time.perf_counter() - t_ref:.3f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    result = {"correct": bool(correct), "attempted": len(run.requests),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        t = run.trace
        dev["busy_s"] = t.busy_s
        dev["window_s"] = t.window_s
        ops = sorted(t.ops.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(t.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[n, s] for n, (_, s) in ops],
                               "idle_gaps": [[n, s] for n, s in gaps]}
    result["check"] = {k: {"value": nums[k], "limit": limits[k]}
                       for k in limits}
    return result, check.lines(nums, limits)


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    args = _parse(argv)
    from harness import cells

    cell = cells.find_cell(args.workload)
    pin_threads(int(cell.traffic["host_threads"]))
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result, check_lines = run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), torch.device("cuda:0"),
                                   t_start=T_START)
    from harness.importcheck import forbidden_modules

    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 4
    log(f"card {_power_limit()}; host threads "
        f"{cell.traffic['host_threads']}")
    for line in check_lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
