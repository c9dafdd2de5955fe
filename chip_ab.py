#!/usr/bin/env python3
"""Compare two checkouts of the repository on one card: phases 1-11 of
each one's ``chip_smoke.py`` (the build, the kernel checks and the four
full-width serving paths, cut before phase 12), run in turns A, B, B, A,
each after a fresh build of its kernels.  Prints one JSON line a run
with the decode p50 (ms) and tok/s of each serving phase.

    python3 chip_ab.py DIR_A DIR_B

where each directory holds a checkout (``git archive`` of a commit,
unpacked).  Needs one card; a run that fails prints its output's end.
"""
import json
import os
import shutil
import subprocess
import sys
import time

CUT = '    with phase("parity") as out:'
REPORT = ('    emit({"ab": {p["phase"]: [p.get("decode_p50_ms"), '
          'p.get("tok_per_s")] for p in RECORD["phases"] '
          'if p["phase"].startswith("serve")}})\n    return 0\n')


def run(root: str) -> dict:
    """Phases 1-11 of ``root``'s chip_smoke.py, built afresh."""
    with open(os.path.join(root, "chip_smoke.py")) as f:
        src = f.read()
    if CUT not in src:
        raise SystemExit(f"{root}/chip_smoke.py has no phase 12 to cut at")
    script = os.path.join(root, "chip_smoke_ab.py")
    with open(script, "w") as f:
        f.write(src.replace(CUT, REPORT + CUT, 1))
    # the build phase reads the ptxas log of a build in its own process
    shutil.rmtree(os.path.join(root, "src", "repro_torch", "kernels",
                               "build"), ignore_errors=True)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, script], cwd=root,
                         capture_output=True, text=True, timeout=900)
    line = next((ln for ln in res.stdout.splitlines()
                 if ln.startswith('{"ab"')), None)
    if line is None:
        print(res.stdout[-3000:], res.stderr[-3000:], flush=True)
        return {"rc": res.returncode}
    return {"rc": res.returncode, "seconds": time.perf_counter() - t0,
            **json.loads(line)}


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (os.path.abspath(d) for d in argv)
    ok = True
    for i, (name, root) in enumerate((("A", a), ("B", b), ("B", b),
                                      ("A", a))):
        out = run(root)
        ok &= out["rc"] == 0
        print(json.dumps({"run": i, "tree": name, "dir": root, **out}),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
