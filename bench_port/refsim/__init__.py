"""The benchmark's plain reference: a frozen copy of mujoco_sim_tpu_torch's
CPU path (the engine, the ops' plain twins, the MJCF compiler and its
native hull helper, the controllers), taken as the port stood when the
benchmark was written, with its imports rewritten to ``refsim`` and the
CUDA wrappers, graph capture and launch counters removed.  It imports
nothing of the program.

Left out, since no configuration of the benchmark reaches them: noslip
(``ops/noslip.py``), rangefinder rays (``ops/raycast.py``), the face-SAT
prototype (``ops/face_sat.py``) and the hardware interface
(``control/hw_interface.py``); a configuration that needs one brings a
copy of it.  A fix to the port's physics has to be made here too, or the
check reads it as a fault.
"""
