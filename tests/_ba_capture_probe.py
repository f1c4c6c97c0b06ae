"""Where the captured sharded bundle adjustment (``sharded_ba.ShardedSolve``)
first leaves the eager ``_solve`` on the card, if it does:

    PYTHONPATH=. python tests/_ba_capture_probe.py [--world N]

In a spawned NCCL world of N cards (default one), every rank solves the
dry run's 6-pose problem (``dryrun.tiny_ba_problem``) and the K = 512
museum problem both ways and compares them bit for bit: the whole solve
of 5 iterations (the tiny one at the multi-process test's settings, the
default PCG steps; the museum one at 50), then one iteration's stages
from the same start: the prologue's linearisation and PCG start
(``_linearize``, every field), one PCG step (``_cg_step``) and the update
(``_update``). It prints, per rank, the first stage and field that
differ and by how much, or that all agree.

Prints the card's name and power limit first. Needs CUDA devices; imports
nothing of JAX.
"""

import argparse
import subprocess
import sys

import torch


def _compare(name: str, got, want) -> str | None:
    """The first differing tensor leaf of two NamedTuples (or tensors)."""
    pairs = (zip(got._fields, got, want) if hasattr(got, "_fields")
             else [(name, got, want)])
    for field, a, b in pairs:
        if not torch.equal(a, b):
            diff = float((a.double() - b.double()).abs().max())
            return f"{name}.{field} differs (max abs {diff:.3g})"
    return None


def case(problem: str) -> list[str]:
    """One problem's comparison on this rank; returns its report lines."""
    from lidar_slam_tpu_torch.io import simulate
    from lidar_slam_tpu_torch.models import ba, state_io
    from lidar_slam_tpu_torch.parallel import dryrun, sharded_ba

    axis = sharded_ba.make_graph_mesh("cuda")
    if problem == "tiny":
        p = dryrun.tiny_ba_problem("cuda")
    else:
        p = state_io.ba_problem_from_numpy(
            ba.BAProblem(**simulate.generate_ba_problem()), "cuda")
    out = []
    cg_iters = None if problem == "tiny" else 50
    whole = [sharded_ba.optimize_ba_sharded(p, axis, iters=5,
                                            cg_iters=cg_iters, eager=eager)
             for eager in (False, True)]
    same = (torch.equal(whole[0].poses, whole[1].poses)
            and torch.equal(whole[0].landmarks, whole[1].landmarks))
    out.append(f"whole solve, 5 iterations of {cg_iters or 'the default'} "
               f"PCG steps: captured {'==' if same else '!='} eager")

    pp = sharded_ba.pad_problem(p, axis.size)
    fac = pp._replace(**{f: axis.rows(getattr(pp, f)) for f in (
        "odo_i", "odo_j", "odo_z", "odo_w", "odo_active",
        "obs_i", "obs_j", "obs_z", "obs_w", "obs_active")})
    damping = 1e-3
    psum = sharded_ba._Scatter(axis)
    with ba._true_f32():
        fx = sharded_ba._fixed(pp.pose_active, pp.lm_active, fac, damping)
        lin, cg = sharded_ba._linearize(fx, pp.poses, pp.landmarks, psum,
                                        damping)
        cg1 = sharded_ba._cg_step(fx, lin, cg, psum, damping)
        upd = sharded_ba._update(fx, lin, cg1, pp.poses, pp.landmarks, psum)
        solve = sharded_ba.ShardedSolve(axis)
        args = (pp.poses, pp.landmarks, pp.pose_active, pp.lm_active, fac)
        solve(*args, 1, 0, damping)
        found = (_compare("linearize", solve.bufs.lin, lin)
                 or _compare("linearize", solve.bufs.cg, cg))
        if found is None:
            solve(*args, 1, 1, damping)
            found = (_compare("cg step", solve.bufs.cg, cg1)
                     or _compare("update", solve.bufs.poses, upd[0])
                     or _compare("update", solve.bufs.lms, upd[1]))
    out.append("one iteration's stages: " + (found or "all equal"))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=1,
                    help="ranks, one card each (default 1)")
    world = ap.parse_args().world
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from lidar_slam_tpu_torch.parallel import multihost

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for problem in ("tiny", "museum"):
        ranks = multihost.launch(world, [(case, (problem,))], "cuda",
                                 timeout_s=300.0)
        for r, (lines,) in enumerate(ranks):
            for line in lines:
                print(f"{problem} problem, rank {r} of {world}: {line}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
