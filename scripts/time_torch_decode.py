"""Time the host JPEG decode of one or more checkouts: `chip_smoke.py`'s
phase 12a (the progressive fixture's CRC32s, then images/s of one 640x480
scene as baseline and as progressive, 8 threads and 1) and phase 13a (the
decoder-coverage fixture's CRC32s), one process per checkout, in the order
given.

    python scripts/time_torch_decode.py [TREE ...]        (default: .)

To compare two commits on one machine, unpack the older one into a
directory that .gitignore lists and run both in the order old, new, new,
old:

    mkdir -p archive_check/parent
    git archive HEAD~1 | tar -x -C archive_check/parent
    python scripts/time_torch_decode.py archive_check/parent . . archive_check/parent

Each checkout builds its own decoder into its own build/.  Prints the
card's name and power limit, then one JSON line per run.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

CHILD = r"""
import json
import chip_smoke as C
facts, _ = C.build_native_loader()
out = {"decoder": facts["decoder"], "12a": C.check_progressive_decode(),
       "13a": C.check_decoder_fixture()}
print(json.dumps(out))
"""


def main(argv=None):
    trees = (argv if argv is not None else sys.argv[1:]) or ["."]
    if shutil.which("nvidia-smi"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
              flush=True)
    for tree in trees:
        tree = os.path.abspath(tree)
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, capture_output=True,
                              text=True, env={**os.environ, "PYTHONPATH": tree})
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"{tree}: rc {proc.returncode}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        rates = {k: round(v["median"], 2) for k, v in res["12a"].items()
                 if k.endswith("images_per_s")}
        print(json.dumps({"tree": os.path.relpath(tree), "decoder": res["decoder"],
                          "12a_crc32_equal": f"{res['12a']['crc32_equal']}/{res['12a']['images']}",
                          "13a_crc32_equal": f"{res['13a']['crc32_equal']}/{res['13a']['images']}",
                          "12a_median_images_per_s": rates, "12a": res["12a"]}), flush=True)


if __name__ == "__main__":
    main()
