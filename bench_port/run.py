"""Run one cell of the benchmark of mujoco_sim_tpu_torch once.

    python3 bench_port/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json (at the checkout's root); its
configuration, traffic mix, limits, entry, law and per-layer readers are
files under bench_port/ found by name (harness/spec.py).  A run:

1. needs as many CUDA devices as the cell asks for, or exits 3 and prints
   no result;
2. set-up: builds the program's model from the configuration on the card
   (the program's kernels load from, or are first built into, its
   checkout), makes the initial state, draws the first episode's inputs
   from the seed and warms up the entry (its step graph is captured);
   ``setup_s`` runs from the start of this process to the first timed
   step;
3. the window: episodes through the entry for --seconds (harness/
   window.py); ``env_steps_per_s`` is every env-step over the window's
   wall time, resets included; ``step_ms_p95`` the 95th percentile of
   each call's CUDA-event time, where the cell reports it;
4. with --trace 1, the per-layer readings (harness/layers.py) in place of
   the end-to-end metrics;
5. the check: the program's state is freed, and the reference (refsim on
   the CPU in float64) decides ``correct`` (harness/check.py);
6. exits 4 and prints no result if jax, jaxlib, flax or mujoco_sim_tpu
   was imported; prints each number compared beside its limit as the last
   lines of standard error, and the result as the last line of standard
   output.

Caches of compiled code stay at fixed paths inside the checkout: the
program builds its kernels into mujoco_sim_tpu_torch/_build/, and Triton
and torch extensions go to bench_port/.cache/.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "mujoco_sim_tpu")

for _p in (BENCH, CHECKOUT):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _cache_dirs():
    cache = os.path.join(BENCH, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """Imported modules whose top-level name is one of FORBIDDEN (compared
    whole: mujoco_sim_tpu_torch is not mujoco_sim_tpu)."""
    return sorted(k for k in list(sys.modules)
                  if k.split(".")[0] in FORBIDDEN)


class Cell:
    """One cell's program side: model, law, entry and initial state,
    warmed up; ``window`` runs it."""

    def __init__(self, cell, device, nenv=None, hooks=None):
        """``hooks["after_model"](self)`` runs once the model is on the
        device (the readings tool switches the program's TF32 on there)."""
        import torch
        from harness import sims, spec
        self.cell, self.dev = cell, device
        cfg, mix = cell.config, cell.traffic
        self.nenv = int(nenv or cfg["nenv"])
        self.phases = {"to_program": time.perf_counter() - _T0}
        t = time.perf_counter()
        self.P = sims.program()
        self.phases["import"] = time.perf_counter() - t
        t = time.perf_counter()
        self.m = sims.build_model(self.P, cfg, sims.DTYPES[cfg["dtype"]],
                                  device)
        self.phases["model"] = time.perf_counter() - t
        if hooks and "after_model" in hooks:
            hooks["after_model"](self)
        self.law = spec.module("laws", mix["law"])
        self.p = mix["law_params"]
        self.bufs = self.law.buffers(self.m, self.nenv, self.p)
        self.entry = spec.module("entries", mix["entry"]).Entry(
            self.P, self.m, self.law, self.bufs, self.p)
        self.carry0 = self.law.carry0(self.P, self.m, self.nenv)
        self.gen = torch.Generator(device=device)

    def fill(self, episode: int) -> dict:
        from harness import window
        d = window.draws(self.cell.traffic["draws"], self.m, self.nenv,
                         self.gen, episode)
        self.law.fill(self.bufs, d, self.m, self.p)
        return self.bufs

    def warm(self, seed: int):
        """Seed the draws, and run the entry (capture and all) on the first
        episode's inputs, so nothing builds inside the window."""
        import torch
        from harness import window
        t = time.perf_counter()
        self.gen.manual_seed(seed % 2 ** 64)
        self.fill(-1)
        self.entry.segment(self.carry0, 2)
        self.law.snap(self.carry0, torch.arange(1, device=self.dev))
        window._sync(self.dev)
        self.phases["warm"] = time.perf_counter() - t

    def window(self, seed: int, seconds: float):
        import torch
        from harness import window
        self.plan = window.Plan.make(self.cell.traffic, self.nenv, seed)
        rows = torch.as_tensor(self.plan.rows, device=self.dev)
        self.entry.timing = True
        if hasattr(self.entry, "events"):
            self.entry.events.clear()
        w = window.run(self.entry, self.law, self.plan, self.carry0,
                       self.fill, seconds, self.nenv, rows, self.dev)
        self.entry.timing = False
        w.start = {k: v.cpu() for k, v in
                   self.law.snap(self.carry0, rows).items()}
        return w


def chosen(cell, w, plan) -> list:
    """The checked steps the check compares: all of the window's, or
    ``points`` of them drawn from the seed."""
    points = int(cell.traffic["check"]["points"])
    picks = (plan.rng.choice(len(w.checks), size=points, replace=False)
             if len(w.checks) > points else range(len(w.checks)))
    return [w.checks[i] for i in sorted(picks)]


def check(cell, checks, start, nrows: int, control: bool = False) -> dict:
    """The numbers ``correct`` compares (``numbers``), the answers checked
    (the sampled envs' steps) and those of them over the per-answer limit,
    and further readings (``more``), from the checked steps and the
    window's initial state of ``nrows`` envs; the reference runs on the
    CPU in float64.  With ``control``, also the control's numbers: the
    reference in float32 with TF32 matmuls, put in the program's place."""
    import torch
    from harness import check as chk, sims, spec
    R = sims.reference()
    law = spec.module("laws", cell.traffic["law"])
    p = cell.traffic["law_params"]
    mr = sims.build_model(R, cell.config, torch.float64, "cpu")
    ref0 = law.snap(law.carry0(R, mr, nrows), torch.arange(nrows))
    start = chk.start_gap(start, ref0)
    post, ref = chk.reference_step(checks, law, R, mr, p)
    numbers, per_answer, more = chk.numbers(post, ref)
    out = {"numbers": {"start_gap": start, **numbers},
           "attempted": len(per_answer),
           "failed": chk.failed_answers(per_answer, cell.limits),
           "more": more}
    if control:
        m32 = sims.build_model(R, cell.config, torch.float32, "cpu")
        _, ctl = chk.reference_step(checks, law, R, m32, p, tf32=True)
        cn, _, cm = chk.numbers(
            sims.snap_data(ctl, torch.arange(ctl.qpos.shape[0])), ref)
        out["control"] = {"start_gap": start, **cn, **cm}
    return out


def main(argv=None, *, device=None, nenv=None) -> int:
    """Run the cell; returns the exit code.  ``device`` and ``nenv`` are
    for the tests: a rehearsal on the CPU at a tiny batch."""
    args = parse(argv)
    _cache_dirs()
    import torch
    from harness import check as chk, spec, stats
    cell = spec.load(args.workload)
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"bench_port: {args.workload} needs {cell.chips} CUDA "
                  f"device(s), found {n}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    c = Cell(cell, device, nenv)
    c.warm(args.seed)
    setup_s = time.perf_counter() - _T0
    w = c.window(args.seed, args.seconds)
    peak = torch.cuda.max_memory_reserved(device) if cuda else 0
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    metrics, extra = {}, {}
    if args.trace:
        if cuda:
            from harness import layers
            readers = {mt["name"]: spec.module("metrics", mt["name"])
                       for mt in cell.per_layer}
            values, busy, win, bd = layers.read(
                c.P, c.m, c.law, c.bufs, c.p, c.entry, w.carry,
                int(cell.traffic["chunk_steps"]), readers)
            units = {mt["name"]: mt["unit"] for mt in cell.per_layer}
            metrics = {k: {"value": v, "unit": units[k]}
                       for k, v in values.items()}
            dev.update(busy_s=busy, window_s=win)
            extra["breakdown"] = bd
    else:
        values = {"env_steps_per_s": stats.rate(w.steps, w.seconds),
                  "setup_s": setup_s}
        if hasattr(c.entry, "call_ms"):
            values["step_ms_p95"] = stats.percentile(c.entry.call_ms(), 95)
        metrics = {mt["name"]: {"value": values[spec.base(mt["name"])],
                                "unit": mt["unit"]}
                   for mt in cell.end_to_end}
    print(f"bench_port: {args.workload} seed {args.seed}: {w.steps} "
          f"env-steps, {w.episodes} episode(s) begun, {w.seconds:.3f} s "
          f"window, {len(w.checks)} checked steps, set-up {setup_s:.3f} s "
          f"({', '.join(f'{k} {v:.3f}' for k, v in c.phases.items())})",
          file=sys.stderr)
    checks, nrows = chosen(cell, w, c.plan), len(c.plan.rows)
    # the program's state goes before the reference runs
    if cuda:
        c.P.graph.clear_all()
    del c, w.carry
    if cuda:
        torch.cuda.empty_cache()
    res = check(cell, checks, w.start, nrows)
    attempted, failed = res["attempted"], res["failed"]
    correct, rows = chk.judge(res["numbers"], cell.limits)
    found = forbidden_modules()
    if found:
        print(f"bench_port: imported {found}", file=sys.stderr)
        return 4
    for name, x, lim in rows:
        print(f"check {name} {x!r} limit {lim!r}", file=sys.stderr)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev, **extra,
              "checks": {name: {"value": x, "limit": lim}
                         for name, x, lim in rows}}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
