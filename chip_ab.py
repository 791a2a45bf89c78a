"""Two checkouts of the port on one card, in turns, so that they can be
compared within one call: each runs in a fresh process from its own
checkout, in the order parent, change, change, parent, and prints

* ring_mv and block_diag_mv at the 2D CN bench's nc = 102,400, f32 and
  f64: device time per call (profiler), back to back and with the L2
  flushed before each call (how the solvers call them there);
* the tridiagonal solve, f32 and f64, back to back: 27,648 and 13,824
  columns of 13 with every operand of one shape, the 3D step's velocity
  solve (coefficients (13,824, 13), right-hand side (2, 13,824, 13): all
  device kernels the call launches, copies of broadcast operands
  included), 4096 columns of 300, and one tile's 64 columns of 13 rows and
  of one row (the latency of a call with next to nothing to move, with
  and without the recurrence's dependent chain);
* ``chip_smoke.py``'s 2D CN slice and 3D baroclinic step (its phases 4
  and 6: ms/step, launches, FGMRES cycles, the profiler's device time of
  one 3D step).

    python3 chip_ab.py PARENT_DIR [CHANGE_DIR]

``PARENT_DIR`` holds an unpacked checkout of the commit to compare with
(``git archive <commit> | tar -x -C <dir>``, into a directory that
``.gitignore`` lists); ``CHANGE_DIR`` defaults to this checkout.  Each
checkout builds its own kernels.  Needs one CUDA card; exits non-zero if a
run fails.
"""
import os
import subprocess
import sys
import time

RUN = """
import importlib.util
import chip_smoke as cs
spec = importlib.util.spec_from_file_location("chip_ab", {path!r})
ab = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ab)
cs.phase_device()
smi = cs.card()
cs.phase_build()
ab.kernels_ab(cs)
cs.phase_slice2d(smi)
cs.phase_slice3d(smi)
print("card:", smi)
"""


def kernels_ab(cs, reps=20):
    """Device µs per call of the working directory's ring_mv and
    block_diag_mv at nc 102,400 and of its tridiagonal solve; ``cs`` is
    that checkout's ``chip_smoke``."""
    import torch
    from thetis_tpu_torch.kernels import ringmv, tridiag
    from thetis_tpu_torch.mesh.generation import RectangleMesh
    from thetis_tpu_torch.solvers.assembled import ring_tables

    dev = torch.device("cuda")
    mesh = RectangleMesh(cs.NX, cs.NY, cs.LX, cs.LY, device=dev,
                         dtype=torch.float64)
    ring, valid = ring_tables(mesh)
    nc = mesh.nc
    g = torch.Generator(device=dev).manual_seed(1234)
    b64, x64, d64 = (torch.randn(shape, generator=g, device=dev,
                                 dtype=torch.float64)
                     for shape in ((4, 9, 9, nc), (9, nc), (9, 9, nc)))
    buf = torch.empty(2**25, dtype=torch.int32, device=dev)  # 128 MB > L2
    cs.device_rows(lambda: torch.ones(8, device=dev) + 1)  # profiler warm-up

    def device_us(fn, flush):
        fn()
        torch.cuda.synchronize()

        def run():
            for _ in range(reps):
                if flush:
                    buf.bitwise_not_()
                fn()

        # all kernels of a call but the flush, over the calls seen of the
        # costliest one
        rows = [r for r in cs.device_rows(run) if "bitwise_not" not in r[2]]
        return sum(r[0] for r in rows) / rows[0][1]

    for dtype in (torch.float32, torch.float64):
        b, x, d = (t.to(dtype) for t in (b64, x64, d64))
        for name, fn in (("ring_mv", lambda: ringmv.ring_mv(b, x, ring,
                                                            valid)),
                         ("block_diag_mv", lambda: ringmv.block_diag_mv(d,
                                                                        x))):
            print(f"[kernel ab] {name} nc={nc} {str(dtype)[6:]}: device µs "
                  f"per call back to back {device_us(fn, False):.2f}, L2 "
                  f"flushed {device_us(fn, True):.2f}", flush=True)

    def rnd(*shape):
        return torch.rand(shape, generator=g, device=dev,
                          dtype=torch.float64) * 2 - 1

    def solve_us(bc, n, nrhs, dtype):
        dl, du = rnd(bc, n), rnd(bc, n)
        dd = 2.0 + dl.abs() + du.abs() + rnd(bc, n).abs()
        rhs = rnd(bc, n) if nrhs == 1 else rnd(nrhs, bc, n)
        ops = [t.to(dtype) for t in (dl, dd, du, rhs)]
        return device_us(lambda: tridiag.tridiag_solve(*ops), False)

    dtypes = (torch.float32, torch.float64)
    for bc, n, nrhs in ((27648, 13, 1), (13824, 13, 1), (13824, 13, 2),
                        (4096, 300, 1), (64, 13, 1), (64, 1, 1)):
        for dtype in dtypes:
            print(f"[kernel ab] tridiag {bc}x{n}"
                  + (f" x{nrhs} shared" if nrhs > 1 else "")
                  + f" {str(dtype)[6:]}: device µs per call back to back "
                  f"{solve_us(bc, n, nrhs, dtype):.2f}", flush=True)


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    trees = {"parent": os.path.abspath(sys.argv[1]),
             "change": os.path.abspath(sys.argv[2] if len(sys.argv) == 3
                                       else here)}
    run = RUN.format(path=os.path.abspath(__file__))
    failed = False
    for tag in ("parent", "change", "change", "parent"):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", run], cwd=trees[tag],
                             capture_output=True, text=True, timeout=900)
        print(f"===== {tag} ({trees[tag]}): rc {out.returncode}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for line in out.stdout.splitlines():
            if line.startswith(("[slice", "[kernel ab]", "card:")):
                print(line, flush=True)
        if out.returncode != 0:
            failed = True
            print(out.stderr[-4000:], flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
