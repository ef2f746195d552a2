"""CLI entry points (the reference's node/executable surface, L6/L7).

  python -m mujoco_sim_tpu_torch serve <config.yaml>  # mujoco_sim node, on the card
  python -m mujoco_sim_tpu_torch compile <in.urdf> [out.xml] [level]
                                                      # mujoco_compile_node
  python -m mujoco_sim_tpu_torch render <model.xml> <out.png> [--steps N] [--device cuda|cpu]
                                                      # offscreen frame of env 0
  python -m mujoco_sim_tpu_torch info <model.xml|.urdf>

`serve` reads a YAML file and needs PyYAML; runtime.config.build(dict)
does not.  `render` steps on the card (`--device cpu` is for tests) and
draws with matplotlib.
"""

from __future__ import annotations

import sys


def _serve(args):
    import time
    from mujoco_sim_tpu_torch.runtime.config import serve

    srv = serve(args[0])
    print(f"mujoco_sim_tpu_torch server on {srv.host}:{srv.port} "
          "(ctrl-c to stop)")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        srv.stop()


def _compile(args):
    """URDF -> MJCF, mirroring mujoco_compile's CLI contract
    (reference: src/mujoco_compile.cpp:32-36,408)."""
    import os
    from mujoco_sim_tpu_torch.models.urdf import load_urdf
    from mujoco_sim_tpu_torch.models.export_mjcf import export_mjcf

    infile = args[0]
    outfile = (args[1] if len(args) > 1
               else os.path.splitext(infile)[0] + ".xml")
    level = int(args[2]) if len(args) > 2 else 1
    spec = load_urdf(infile, collision_level=level)
    export_mjcf(spec, outfile)
    print(f"compiled {infile} -> {outfile} (collision level {level})")


def _render(args):
    import torch
    from mujoco_sim_tpu_torch import engine
    from mujoco_sim_tpu_torch.models.compile import load_model
    from mujoco_sim_tpu_torch.parallel.rollout import rollout
    from mujoco_sim_tpu_torch.utils.graph import StepGraph
    from mujoco_sim_tpu_torch.utils.struct import host_env
    from mujoco_sim_tpu_torch.viz.render import render_frame

    path, out = args[0], args[1]
    steps = int(args[args.index("--steps") + 1]) if "--steps" in args else 0
    device = args[args.index("--device") + 1] if "--device" in args \
        else "cuda"
    m = engine.put_model(load_model(path), torch.float32, device)
    d = StepGraph(engine.forward)(m, rollout(m, engine.make_data(m, 1),
                                             steps))
    hm, hd = host_env(m, d)
    render_frame(hm, hd, out)
    print(f"rendered {path} @ t={float(hd.time):.3f}s -> {out}")


def _info(args):
    from mujoco_sim_tpu_torch.models.compile import load_model
    from mujoco_sim_tpu_torch.models.urdf import compile_urdf

    path = args[0]
    m = (compile_urdf(path) if path.endswith(".urdf") else load_model(path))
    print(f"model: {path}")
    print(f"  nq={m.nq} nv={m.nv} nbody={m.nbody} njnt={m.njnt} "
          f"ngeom={m.ngeom} nmesh={m.nmesh} neq={m.neq}")
    print(f"  collision: {m.npair} pairs, {m.ncand} candidates, "
          f"budget K={m.ncon_max}, {m.nefc_max} efc rows "
          f"({m.npair_unsupported} unsupported pair types)")
    print(f"  integrator={'Euler RK4 implicit implicitfast'.split()[m.opt.integrator]} "
          f"timestep={float(m.opt.timestep)}")
    print("  bodies:", " ".join(m.names.body[1:12]),
          "..." if m.nbody > 12 else "")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    cmd, args = argv[0], argv[1:]
    fn = {"serve": _serve, "compile": _compile, "render": _render,
          "info": _info}.get(cmd)
    if fn is None:
        print(__doc__)
        return 1
    fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
