"""The readings the limits of ``correct`` are set from, for one cell.

On the card, in one process (its set-up is paid once), a window of the
cell's own load and length through the timed path for each seed, and
the checked steps that a run of that seed compares:

    python3 bench_port/tools/readings.py --workload <cell> \\
        --seconds <s> --seeds <first> <count> [--control <count>] \\
        [--save <dir>]

Without --save the check's numbers (harness/check.py) follow on the
machine's CPU, printed as JSON lines: the program as the configuration
states it (float32, TF32 off, as put_model sets it), side "program", and
the control on the same checked steps, side "reference_tf32": the
reference put in the program's place in float32 with TF32 matmuls
(harness/tf32.py), TF32 being the nearest precision below float32 with
TF32 off.  With --control n, n more seeds of the program's own TF32 path
(its matmuls on TF32 tensor cores where cuBLAS picks them; captured
anew), side "program_tf32".  With --save, each seed's checked steps and
initial state go to <dir>/<cell>.<seed>.pt.xz instead, and

    python3 bench_port/tools/readings.py --workload <cell> --load <dir>

reads the numbers from them on any machine's CPU (the reference never
needs the card).  The lower reading of a number is the largest the
program gives, the upper the smallest a control gives.
"""

from __future__ import annotations

import argparse
import glob
import io
import lzma
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import run  # noqa: E402


def tf32_on(cell):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")


def _cpu(x):
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu(v) for v in x)
    return x.cpu() if hasattr(x, "cpu") else x


def windows(workload: str, seconds: float, seeds, control: bool,
            device=None, nenv=None):
    """Yield (seed, cell, the compared checked steps on the CPU, the
    initial state, sampled envs, checked steps of the window) for each
    seed."""
    import torch
    from harness import spec
    run._cache_dirs()
    cell = spec.load(workload)
    dev = torch.device(device or "cuda")
    c = run.Cell(cell, dev, nenv, {"after_model": tf32_on} if control
                 else None)
    for seed in seeds:
        c.warm(seed)
        w = c.window(seed, seconds)
        w.carry = None
        yield (seed, cell, _cpu(run.chosen(cell, w, c.plan)), w.start,
               len(c.plan.rows), len(w.checks))


def _kept(checks) -> list:
    """The checked steps as the check reads them: the state before, and
    of the state after only what the numbers compare."""
    from harness import check, sims
    out = []
    for ep, step, pre, post, inputs in checks:
        pre = {k: v for k, v in pre.items()
               if k in sims.STATE or k.startswith("pd.")}
        post = {k: v for k, v in post.items() if k in check.READ
                or k.startswith("contact.")}
        out.append((ep, step, pre, post, inputs))
    return out


def _print(workload, side, seed, n, numbers, more=None):
    print(json.dumps({"workload": workload, "side": side, "seed": seed,
                      "checked_steps": n, **numbers, **(more or {})}),
          flush=True)


def _report(workload, side, seed, n, cell, checks, start, nrows,
            control):
    res = run.check(cell, checks, start, nrows, control=control)
    _print(workload, side, seed, n, res["numbers"], res["more"])
    if "control" in res:
        _print(workload, "reference_tf32", seed, n, res["control"])


def load(workload: str, folder: str):
    from harness import spec
    cell = spec.load(workload)
    for path in sorted(glob.glob(os.path.join(folder,
                                              workload + ".*.pt.xz"))):
        import torch
        with lzma.open(path, "rb") as f:
            s = torch.load(io.BytesIO(f.read()), weights_only=False)
        _report(workload, s["side"], s["seed"], s["checked_steps"], cell,
                s["checks"], s["start"], s["nrows"],
                control=s["side"] == "program")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--seeds", type=int, nargs=2, metavar=("FIRST", "COUNT"))
    ap.add_argument("--control", type=int, default=0,
                    help="seeds of the control after the program's")
    ap.add_argument("--save", help="keep the checked steps here")
    ap.add_argument("--load", help="read the numbers of kept steps")
    ap.add_argument("--device", default="cuda",
                    help="cpu with --nenv: a rehearsal")
    ap.add_argument("--nenv", type=int)
    args = ap.parse_args(argv)
    if args.load:
        return load(args.workload, args.load)
    first, count = args.seeds
    for ctl, seeds in ((False, range(first, first + count)),
                       (True, range(first + count,
                                    first + count + args.control))):
        if not seeds:
            continue
        side = "program_tf32" if ctl else "program"
        try:
            for seed, cell, checks, start, nrows, n in windows(
                    args.workload, args.seconds, seeds, ctl, args.device,
                    args.nenv):
                if args.save:
                    import torch
                    os.makedirs(args.save, exist_ok=True)
                    buf = io.BytesIO()
                    torch.save({"side": side, "seed": seed,
                                "checked_steps": n, "checks": _kept(checks),
                                "start": start, "nrows": nrows}, buf)
                    with lzma.open(os.path.join(
                            args.save, f"{args.workload}.{seed}.pt.xz"),
                            "wb") as f:
                        f.write(buf.getvalue())
                    print(f"saved {args.workload} {side} seed {seed}: {n} "
                          f"checked steps", flush=True)
                else:
                    _report(args.workload, side, seed, n, cell, checks,
                            start, nrows, control=not ctl)
        except Exception as e:   # a control that crashes has failed
            print(json.dumps({"workload": args.workload, "control": ctl,
                              "error": repr(e)}), flush=True)
        if not ctl and args.device == "cuda":
            import torch
            from mujoco_sim_tpu_torch.utils import graph
            graph.clear_all()
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
