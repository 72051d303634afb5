"""Times this checkout's selective-scan forward (K1) or backward (K2) kernel,
or its fused cross-scan forward (K3) or backward (K4), against the same
kernel of other checkouts of the package, in one process on one card.

    python -m nnuzoo_tpu_torch.kernel_timing [--kernel fwd|bwd|cross_fwd|cross_bwd] --other DIR [--other DIR ...]

Each DIR holds a ``nnuzoo_tpu_torch`` package from another commit (for the
parent: ``git archive <commit> nnuzoo_tpu_torch | tar -x -C DIR``, with DIR
under the gitignored ``build/``); it is imported under another name and
builds its own kernels into ``DIR/build/kernels``. The script prints the
card, each version's ``ptxas -v`` lines, then for every scan length of an
M2NetP forward (and L=12, and steep decay at L=3584, on ``chip_smoke.py``'s
seeded inputs) each version's error against the plain version and its time
in turns (others, this, this, others reversed), the host's time to issue a
call, each kernel's device time (from torch.profiler), and the times
weighted by the calls of each length in one forward or training step.
``--kernel bwd`` (the default) times K2 at ``--batch`` (12) against
``scan_core_bwd_plain``. ``--kernel fwd`` times K1 as serving calls it
(batch 4, no carries) and as training does (batch 12, with the carries the
backward starts from), y against ``scan_core_plain`` and the carries against
its carries; ``--trace`` adds each version's per-block phases (walk 1,
look-back, walk 2) from the kernel's trace. ``--kernel cross_fwd`` times K3
in both orientations as serving calls it (batch 4, no carries) and as
training does (batch 12, with the carries K4 starts from), at the path's
lengths, L=12 and L=1000 (G=2, Dh=32, R=1), and G=3, Dh=64, R=2 and G=2,
Dh=256, R=8 for the errors: y against ``cross_scan_ref``, the carries
against the first ``--other`` version's; its totals weigh each length by
the n calls in each orientation of a serving forward and a training step.
``--kernel cross_bwd`` times K4
at ``--batch`` in both orientations at the path's lengths, L=12 and L=1000
(G=2, Dh=32, R=1, from this checkout's K3 carries), with the errors of the
d_streams and of each weight gradient against ``cross_scan_bwd_plain``, and
adds G=3, Dh=64, R=2 and G=2, Dh=256, R=8 for the errors; its step total
weighs each length by the 2n calls of a training step with the fused glue.
Every line is JSON and also goes to ``chiprun_out/kernel_timing.jsonl``.
Needs a CUDA card; exits non-zero without one or when a version disagrees
with the plain version beyond 1e-4 of an output's max (for K4's weight
gradients, sums over up to B*L positions, 1e-3), or a version's K3 carries
with the first other version's beyond 1e-4 of their max.
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
from .ops import cross_scan as this_cross
from .ops import selective_scan as this_scan

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# the path's shapes, the seeded inputs, the timer and the bound of the
# smoke run at the root of the checkout
import chip_smoke  # noqa: E402
from chip_smoke import (CROSS_DH, CROSS_G, CROSS_R, CROSS_TOL,  # noqa: E402
                        CROSS_WEIGHT_GRAD_TOL, K_DIRS, KD, N_STATE,
                        PATH_SHAPES, TILE_BATCH, TRAIN_BATCH)
LOG = ROOT / "chiprun_out" / "kernel_timing.jsonl"
TOL = 1e-4


def emit(**fields):
    line = json.dumps(fields)
    print(line, flush=True)
    with open(LOG, "a") as f:
        f.write(line + "\n")


def load_other(directory, alias, ops_module):
    """The ``nnuzoo_tpu_torch`` package under ``directory``, imported as
    ``alias``; returns its ``ops.<ops_module>`` and ``_build``."""
    pkg = Path(directory).resolve() / "nnuzoo_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return (importlib.import_module(f"{alias}.ops.{ops_module}"),
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


def rel_error(got, want):
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def rel_errors(got, want):
    return {name: rel_error(g, w)
            for name, g, w in zip(("du", "ddelta", "dbc", "dA"), got, want)}


def cases():
    """(L, steep) of every run: the path's lengths, L=12, steep decay."""
    return [(L, False) for L, _ in PATH_SHAPES] + [(12, False), (3584, True)]


def timed(row, versions, order, call, reps):
    """Each version's time in turns, host issue time and device time by
    kernel, into ``row``; ``call(scan)`` makes one call of a version. Up to
    L=3584 a call's time comes near the host's issue time, which spreads from
    run to run (a stall of the host's clock lands on both turns of a
    version, which run one after the other): those turns take five times
    the calls."""
    reps = reps if row["L"] > 3584 else 5 * reps
    times = {v: [] for v in versions}
    for label in order:
        scan = versions[label][0]
        times[label].append(chip_smoke.time_ms(lambda: call(scan), reps))
    row["ms"] = {v: sum(t) / len(t) for v, t in times.items()}
    row["ms_each"] = times
    row["host_ms"], row["device_us"] = {}, {}
    for label, (scan, _) in versions.items():
        row["host_ms"][label] = host_ms(lambda: call(scan))
        row["device_us"][label] = device_us_by_kernel(lambda: call(scan))


def time_backward(versions, order, batch, reps):
    weight = dict(PATH_SHAPES)
    totals = {v: 0.0 for v in versions}
    failed = []
    for L, steep in cases():
        (u, delta, A_t, bc), dy = chip_smoke.scan_inputs(
            batch, L, KD, N_STATE, K_DIRS, seed=L, steep=steep)
        with torch.inference_mode():
            y, carries = this_scan.scan_core(u, delta, A_t, bc, return_carries=True)
            carries = carries if carries.shape[1] > 1 else None
            want = this_scan.scan_core_bwd_plain(u, delta, A_t, bc, dy)
            row = dict(B=batch, L=L, steep=steep,
                       bound_ms=chip_smoke.scan_bwd_bound(
                           batch, L, KD, N_STATE, K_DIRS)[0], err={})
            for label, (scan, _) in versions.items():
                got = scan.scan_core_bwd(u, delta, A_t, bc, dy, carries)
                torch.cuda.synchronize()
                row["err"][label] = rel_errors(got, want)
                if max(row["err"][label].values()) > TOL:
                    failed.append((label, L, steep))
                del got
            timed(row, versions, order,
                  lambda scan: scan.scan_core_bwd(u, delta, A_t, bc, dy, carries),
                  reps)
        emit(**row)
        if L in weight and not steep:
            for v in versions:
                totals[v] += weight[L] * row["ms"][v]
        del u, delta, A_t, bc, dy, y, carries, want
        torch.cuda.empty_cache()
    emit(step_weighted_ms=totals,
         step_bound_ms=sum(n * chip_smoke.scan_bwd_bound(
             batch, L, KD, N_STATE, K_DIRS)[0] for L, n in PATH_SHAPES),
         failed=failed)
    return failed


CROSS_NAMES = ("d_streams", "dWx", "dWdt", "dbias", "dA", "dD")


def cross_cases():
    """(L, G, Dh, R) of K3's and K4's runs: the path's lengths, L=12 and L=1000 at
    M2NetP's widths, then G=3 with Dh=64 and R=2 and M2Net's width (for the
    errors; off the path, so out of the step's total)."""
    fused = (CROSS_G, CROSS_DH, CROSS_R)
    return ([(L, *fused) for L, _ in PATH_SHAPES] + [(12, *fused), (1000, *fused)]
            + [(301, 3, 64, 2), (56, 2, 256, 8)])


def cross_errors(got, want):
    """Each output's max abs error over its max, the G d_streams as one."""
    flat = lambda t: [torch.cat(list(t[0]), -1), *t[1:]]
    return {name: rel_error(g, w)
            for name, g, w in zip(CROSS_NAMES, flat(got), flat(want))}


def time_cross_backward(versions, order, batch, reps):
    """K4 at ``batch``, both orientations, from this checkout's K3 carries;
    the step total counts each path length's n calls in each orientation."""
    weight = dict(PATH_SHAPES)
    fused = (CROSS_G, CROSS_DH, CROSS_R)
    totals = {v: 0.0 for v in versions}
    failed = []
    for i, (L, g, dh, r) in enumerate(cross_cases()):
        streams, w, dy = chip_smoke.cross_inputs(batch, L, g, dh, r, seed=200 + i)
        for reverse in (False, True):
            with torch.inference_mode():
                _, carries = this_cross.cross_scan_fwd(streams, *w, reverse,
                                                       return_carries=True)
                want = this_cross.cross_scan_bwd_plain(streams, *w, dy, reverse)
                row = dict(B=batch, L=L, G=g, Dh=dh, R=r, reverse=reverse,
                           bound_ms=chip_smoke.cross_bound(
                               batch, L, g, dh, N_STATE, r, True)[0], err={})
                for label, (cross, _) in versions.items():
                    got = cross.cross_scan_bwd(streams, *w, dy, reverse, carries)
                    torch.cuda.synchronize()
                    errs = cross_errors(got, want)
                    row["err"][label] = errs
                    if any(e > (CROSS_TOL if k == "d_streams"
                                else CROSS_WEIGHT_GRAD_TOL)
                           for k, e in errs.items()):
                        failed.append((label, L, g, dh, r, reverse))
                    del got
                del want
                timed(row, versions, order,
                      lambda cross: cross.cross_scan_bwd(streams, *w, dy, reverse,
                                                         carries), reps)
            emit(**row)
            if L in weight and (g, dh, r) == fused:
                for v in versions:
                    totals[v] += weight[L] * row["ms"][v]
            del carries
        del streams, w, dy
        torch.cuda.empty_cache()
    emit(step_weighted_ms=totals,
         step_bound_ms=2 * sum(n * chip_smoke.cross_bound(
             batch, L, *fused[:2], N_STATE, fused[2], True)[0]
             for L, n in PATH_SHAPES),
         failed=failed)
    return failed


def time_cross_forward(versions, order, reps):
    """K3 at the serving batch without carries and at the training batch
    with them, both orientations; y against ``cross_scan_ref``, the carries
    against the first other version's (this version's with no other). The
    totals count each path length's n calls in each orientation."""
    weight = dict(PATH_SHAPES)
    fused = (CROSS_G, CROSS_DH, CROSS_R)
    batches = (TILE_BATCH, TRAIN_BATCH)
    totals = {(b, v): 0.0 for b in batches for v in versions}
    failed = []
    first = next(iter(versions))
    for i, (L, g, dh, r) in enumerate(cross_cases()):
        for batch in batches:
            train = batch == TRAIN_BATCH
            streams, w, _ = chip_smoke.cross_inputs(batch, L, g, dh, r,
                                                    seed=300 + i)
            for reverse in (False, True):
                with torch.inference_mode():
                    want = this_cross.cross_scan_ref(streams, *w, reverse)
                    row = dict(B=batch, L=L, G=g, Dh=dh, R=r, reverse=reverse,
                               carries=train,
                               bound_ms=chip_smoke.cross_bound(
                                   batch, L, g, dh, N_STATE, r, False)[0],
                               err={})
                    ref_carries = None
                    for label in [first] + [v for v in versions if v != first]:
                        cross = versions[label][0]
                        y, carries = cross.cross_scan_fwd(streams, *w, reverse,
                                                          return_carries=True)
                        torch.cuda.synchronize()
                        errs = dict(y=rel_error(y, want))
                        if carries is not None:
                            if ref_carries is None:
                                ref_carries = carries
                            errs["carries"] = rel_error(carries, ref_carries)
                        row["err"][label] = errs
                        if max(errs.values()) > TOL:
                            failed.append((label, batch, L, g, dh, r, reverse))
                        del y
                    del want, ref_carries, carries
                    timed(row, versions, order,
                          lambda cross: cross.cross_scan_fwd(
                              streams, *w, reverse, return_carries=train), reps)
                emit(**row)
                if L in weight and (g, dh, r) == fused:
                    for v in versions:
                        totals[batch, v] += weight[L] * row["ms"][v]
            del streams, w
            torch.cuda.empty_cache()
    bound = {b: 2 * sum(n * chip_smoke.cross_bound(b, L, *fused[:2], N_STATE,
                                                   fused[2], False)[0]
                        for L, n in PATH_SHAPES) for b in batches}
    emit(serving_forward_ms={v: totals[TILE_BATCH, v] for v in versions},
         serving_forward_bound_ms=bound[TILE_BATCH],
         step_weighted_ms={v: totals[TRAIN_BATCH, v] for v in versions},
         step_bound_ms=bound[TRAIN_BATCH], failed=failed)
    return failed


def time_forward(versions, order, reps):
    """K1 at the serving batch without carries and at the training batch
    with them; the totals are one forward's 80 calls of each."""
    weight = dict(PATH_SHAPES)
    totals = {(b, v): 0.0 for b in (TILE_BATCH, TRAIN_BATCH) for v in versions}
    failed = []
    for L, steep in cases():
        for batch in (TILE_BATCH, TRAIN_BATCH):
            train = batch == TRAIN_BATCH
            (u, delta, A_t, bc), _ = chip_smoke.scan_inputs(
                batch, L, KD, N_STATE, K_DIRS, seed=L, steep=steep)
            with torch.inference_mode():
                want, want_carries = this_scan.scan_core_plain(
                    u, delta, A_t, bc, chunk=this_scan._pick_chunk(batch, L, KD),
                    return_carries=True)
                row = dict(B=batch, L=L, steep=steep, carries=train,
                           bound_ms=chip_smoke.scan_bound(
                               batch, L, KD, N_STATE, K_DIRS)[0], err={})
                for label, (scan, _) in versions.items():
                    y, carries = scan.scan_core(u, delta, A_t, bc,
                                                return_carries=True)
                    torch.cuda.synchronize()
                    row["err"][label] = dict(y=rel_error(y, want),
                                             carries=rel_error(carries, want_carries))
                    if max(row["err"][label].values()) > TOL:
                        failed.append((label, batch, L, steep))
                    del y, carries
                del want, want_carries
                timed(row, versions, order,
                      lambda scan: scan.scan_core(u, delta, A_t, bc,
                                                  return_carries=train), reps)
            emit(**row)
            if L in weight and not steep:
                for v in versions:
                    totals[batch, v] += weight[L] * row["ms"][v]
            del u, delta, A_t, bc
            torch.cuda.empty_cache()
    bound = {b: sum(n * chip_smoke.scan_bound(b, L, KD, N_STATE, K_DIRS)[0]
                    for L, n in PATH_SHAPES) for b in (TILE_BATCH, TRAIN_BATCH)}
    emit(serving_forward_ms={v: totals[TILE_BATCH, v] for v in versions},
         serving_forward_bound_ms=bound[TILE_BATCH],
         step_weighted_ms={v: totals[TRAIN_BATCH, v] for v in versions},
         step_bound_ms=bound[TRAIN_BATCH], failed=failed)
    return failed


def forward_trace(scan, build, batch, L):
    """The phases of one forward call (this version's kernel or a copy with
    the same trace entry) from the kernel's per-block trace, in µs a block:
    walk 1 (with the wait for the first staged steps), the look-back (split
    into publishing the tile's aggregate and, by a group's last tile, the
    group's; polling the groups' flags; applying the groups' aggregates; and
    the rest, which publishes the group's inclusive state and applies the
    group's earlier tiles) and walk 2; the group and tile aggregates
    applied; the call's span and the blocks running at once on average.
    None for a version without the trace."""
    import ctypes
    import numpy as np
    lib = build.load("selective_scan_fwd")
    if not hasattr(lib, "nnuzoo_selective_scan_fwd_trace"):
        return None
    setter = lib.nnuzoo_selective_scan_fwd_trace
    setter.argtypes, setter.restype = [ctypes.c_void_p], ctypes.c_int
    train = batch == TRAIN_BATCH
    (u, delta, A_t, bc), _ = chip_smoke.scan_inputs(
        batch, L, KD, N_STATE, K_DIRS, seed=L)
    plan = scan._fwd_plan(batch, L, KD, K_DIRS, N_STATE, *scan._fwd_kernel_fns()[1:])
    with torch.inference_mode():
        scan.scan_core(u, delta, A_t, bc, return_carries=train)
        trace = torch.zeros(plan["blocks"], 8, dtype=torch.int64, device="cuda")
        torch.cuda.synchronize()
        slots = setter(trace.data_ptr())
        try:
            scan.scan_core(u, delta, A_t, bc, return_carries=train)
            torch.cuda.synchronize()
        finally:
            setter(None)
    if slots != trace.shape[1]:
        raise RuntimeError(f"trace entry returned {slots}")
    t = trace.cpu().numpy().astype(np.float64)
    start, walk1, look, end = (t[:, i] for i in range(4))

    def stats(x):
        return dict(mean=float(x.mean()), p50=float(np.percentile(x, 50)),
                    p90=float(np.percentile(x, 90)), max=float(x.max()))

    span = end.max() - start.min()
    counts = trace[:, 6].cpu().numpy()
    looked = t[:, 5] > 0          # the first group's tiles do not look back
    return dict(B=batch, L=L, carries=train, blocks=plan["blocks"],
                tile=scan._fwd_kernel_fns()[1], group=scan._fwd_kernel_fns()[2],
                span_us=span / 1e3,
                walk1_us=stats((walk1 - start) / 1e3),
                look_back_us=stats((look - walk1) / 1e3),
                publish_us=stats((t[:, 7] - walk1) / 1e3),
                poll_us=stats((t[looked, 5] - t[looked, 7]) / 1e3),
                groups_us=stats((t[looked, 4] - t[looked, 5]) / 1e3),
                tiles_us=stats((look - t[:, 4]) / 1e3),
                walk2_us=stats((end - look) / 1e3),
                groups_applied=stats((counts & 0xFFFFFFFF).astype(np.float64)),
                tiles_applied=stats((counts >> 32).astype(np.float64)),
                blocks_at_once=float((end - start).sum() / span))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=("fwd", "bwd", "cross_fwd", "cross_bwd"),
                        default="bwd")
    parser.add_argument("--other", action="append", default=[],
                        help="a directory holding another nnuzoo_tpu_torch")
    parser.add_argument("--batch", type=int, default=12,
                        help="batch of the backward's runs (K2's and K4's)")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--trace", action="store_true",
                        help="with --kernel fwd: each version's per-block "
                             "phases at L=57344 and 3584, both batches")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device", file=sys.stderr)
        return 1
    LOG.parent.mkdir(exist_ok=True)
    LOG.write_text("")
    emit(card=chip_smoke.card_line(), torch=torch.__version__,
         cuda=torch.version.cuda, kernel=args.kernel)

    module, this, source = {
        "fwd": ("selective_scan", this_scan, "selective_scan_fwd"),
        "bwd": ("selective_scan", this_scan, "selective_scan_bwd"),
        "cross_fwd": ("cross_scan", this_cross, "cross_scan_fwd"),
        "cross_bwd": ("cross_scan", this_cross, "cross_scan_bwd"),
    }[args.kernel]
    versions = {}
    for i, directory in enumerate(args.other):
        versions[f"other{i}:{directory}"] = load_other(directory, f"scan_other{i}",
                                                       module)
    versions["this"] = (this, _build)
    for label, (_, build) in versions.items():
        logs = build.build_all()
        log = logs.get(source, "(built before)")
        emit(version=label, ptxas=[line.strip() for line in log.splitlines()
                                   if re.search(r"registers|spill|Compiling", line)])
    others = [v for v in versions if v != "this"]
    order = others + ["this", "this"] + others[::-1]
    if args.kernel == "fwd":
        if args.trace:
            for label, (scan, build) in versions.items():
                for L in (57344, 3584):
                    for batch in (TILE_BATCH, TRAIN_BATCH):
                        phases = forward_trace(scan, build, batch, L)
                        if phases is not None:
                            emit(version=label, trace=phases)
                torch.cuda.empty_cache()
        failed = time_forward(versions, order, args.reps)
    elif args.kernel == "cross_fwd":
        failed = time_cross_forward(versions, order, args.reps)
    elif args.kernel == "cross_bwd":
        failed = time_cross_backward(versions, order, args.batch, args.reps)
    else:
        failed = time_backward(versions, order, args.batch, args.reps)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
