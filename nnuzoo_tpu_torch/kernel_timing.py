"""Times this checkout's selective-scan backward kernel (K2) against the same
kernel of other checkouts of the package, in one process on one card.

    python -m nnuzoo_tpu_torch.kernel_timing --other DIR [--other DIR ...]

Each DIR holds a ``nnuzoo_tpu_torch`` package from another commit (for the
parent: ``git archive <commit> nnuzoo_tpu_torch | tar -x -C DIR``, with DIR
under the gitignored ``build/``); it is imported under another name and
builds its own kernels into ``DIR/build/kernels``. The script prints the
card, each version's ``ptxas -v`` lines, then for every scan length of an
M2NetP training step at batch 12 (and L=12, and steep decay at L=3584, on
``chip_smoke.py``'s seeded inputs) each version's error against
``scan_core_bwd_plain`` and its time in turns (others, this, this, others
reversed), the host's time to issue a call, each kernel's device time (from
torch.profiler), and the times weighted by the calls of each length in one
step.
Every line is JSON and also goes to ``chiprun_out/kernel_timing.jsonl``.
Needs a CUDA card; exits non-zero without one or when a version disagrees
with the plain backward beyond 1e-4 of a gradient's max.
"""

import argparse
import importlib.util
import json
import re
import sys
import time
from pathlib import Path

import torch

from . import _build
from .ops import selective_scan as this_scan

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# the path's shapes, the seeded inputs, the timer and the bound of the
# smoke run at the root of the checkout
import chip_smoke  # noqa: E402
from chip_smoke import K_DIRS, KD, N_STATE, PATH_SHAPES  # noqa: E402
LOG = ROOT / "chiprun_out" / "kernel_timing.jsonl"
TOL = 1e-4


def emit(**fields):
    line = json.dumps(fields)
    print(line, flush=True)
    with open(LOG, "a") as f:
        f.write(line + "\n")


def load_other(directory, alias):
    """The ``nnuzoo_tpu_torch`` package under ``directory``, imported as
    ``alias``; returns its ``ops.selective_scan`` and ``_build``."""
    pkg = Path(directory).resolve() / "nnuzoo_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return (importlib.import_module(f"{alias}.ops.selective_scan"),
            importlib.import_module(f"{alias}._build"))


def host_ms(fn, reps=50):
    """Host time to issue one call, the card not waited for: where it comes
    near the card's time, the call is bound by the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def device_us_by_kernel(fn, reps=3):
    """Device microseconds per call of each kernel that ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            found = re.search(r"(\w+)(<[^(]*>)?\(", e.key)
            name = found.group(1) if found else e.key
            out[name] = out.get(name, 0.0) + e.self_device_time_total / reps
    return out


def rel_errors(got, want):
    return {name: (g - w).abs().max().item() / w.abs().max().item()
            for name, g, w in zip(("du", "ddelta", "dbc", "dA"), got, want)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", action="append", default=[],
                        help="a directory holding another nnuzoo_tpu_torch")
    parser.add_argument("--batch", type=int, default=12)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device", file=sys.stderr)
        return 1
    LOG.parent.mkdir(exist_ok=True)
    LOG.write_text("")
    emit(card=chip_smoke.card_line(), torch=torch.__version__,
         cuda=torch.version.cuda)

    versions = {}
    for i, directory in enumerate(args.other):
        versions[f"other{i}:{directory}"] = load_other(directory, f"k2_other{i}")
    versions["this"] = (this_scan, _build)
    for label, (_, build) in versions.items():
        logs = build.build_all()
        log = logs.get("selective_scan_bwd", "(built before)")
        emit(version=label, ptxas=[line.strip() for line in log.splitlines()
                                   if re.search(r"registers|spill|Compiling", line)])
    others = [v for v in versions if v != "this"]
    order = others + ["this", "this"] + others[::-1]

    weight = dict(PATH_SHAPES)
    totals = {v: 0.0 for v in versions}
    failed = []
    cases = [(L, False) for L, _ in PATH_SHAPES] + [(12, False), (3584, True)]
    for L, steep in cases:
        (u, delta, A_t, bc), dy = chip_smoke.scan_inputs(
            args.batch, L, KD, N_STATE, K_DIRS, seed=L, steep=steep)
        with torch.inference_mode():
            y, carries = this_scan.scan_core(u, delta, A_t, bc, return_carries=True)
            carries = carries if carries.shape[1] > 1 else None
            want = this_scan.scan_core_bwd_plain(u, delta, A_t, bc, dy)
            row = dict(B=args.batch, L=L, steep=steep,
                       bound_ms=chip_smoke.scan_bwd_bound(
                           args.batch, L, KD, N_STATE, K_DIRS)[0], err={}, ms={})
            for label, (scan, _) in versions.items():
                got = scan.scan_core_bwd(u, delta, A_t, bc, dy, carries)
                torch.cuda.synchronize()
                row["err"][label] = rel_errors(got, want)
                if max(row["err"][label].values()) > TOL:
                    failed.append((label, L, steep))
                del got
            times = {v: [] for v in versions}
            for label in order:
                scan = versions[label][0]
                times[label].append(chip_smoke.time_ms(
                    lambda: scan.scan_core_bwd(u, delta, A_t, bc, dy, carries),
                    args.reps))
            row["ms"] = {v: sum(t) / len(t) for v, t in times.items()}
            row["ms_each"] = times
            row["host_ms"] = {}
            row["device_us"] = {}
            for label, (scan, _) in versions.items():
                call = lambda: scan.scan_core_bwd(u, delta, A_t, bc, dy, carries)
                row["host_ms"][label] = host_ms(call)
                row["device_us"][label] = device_us_by_kernel(call)
        emit(**row)
        if L in weight and not steep:
            for v in versions:
                totals[v] += weight[L] * row["ms"][v]
        del u, delta, A_t, bc, dy, y, carries, want
        torch.cuda.empty_cache()
    emit(step_weighted_ms=totals,
         step_bound_ms=sum(n * chip_smoke.scan_bwd_bound(
             args.batch, L, KD, N_STATE, K_DIRS)[0] for L, n in PATH_SHAPES),
         failed=failed)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
