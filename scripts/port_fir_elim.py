#!/usr/bin/env python3
"""Copies of a tree whose kernel H (``csrc/probe_fir.cu``) each drops one
part of its work, for an elimination split of what binds it.

    python3 scripts/port_fir_elim.py TREE DEST

Writes ``DEST/<part>/`` for each part below: ``flowhigh_tpu_torch/``,
``scripts/`` and ``chip_smoke.py`` of TREE with one edit to the kernel.
Each copy keeps the kernel's loads and barriers unless the part is the
loads themselves. Time the copies beside TREE in one call with
``scripts/port_kernel_ab.py --fir``; copy TREE's built libraries into
``DEST/<part>/build/flowhigh_tpu_torch/`` first so that only the edited
source rebuilds. The copies compute wrong values.

The earlier kernel H (f32 by FMAs from shared memory, bf16 on
``mma.sync``), and the tensor-core kernel H (f32 in 3xTF32 on
``mma.sync``, bf16 on ``wgmma``) alike:
- ``gemm1``: the up-FIR product's arithmetic dropped (its fragment loads
  with it, which the compiler then removes): s2 is the snake of zeros;
- ``gemm2``: the down-FIR product's arithmetic dropped;
- ``loads``: no weight copies after the ring's first stages: the later
  slices are served from them (the tensor-core kernel still arrives on
  each slot's mbarrier, with no bytes);
- ``snake``: the snake skipped (the instances with the snake then do what
  the dots-only ones do).
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

SRC = Path("flowhigh_tpu_torch") / "csrc" / "probe_fir.cu"
# part: [(text in the kernel, replacement, occurrences)]
FMA = {
    "gemm1": [("      tile_mma<4, KS1>(acc1, 4, xs, lda_x, wm * 16 + q, kb, "
               "buf, ldb1,\n                       wn * 32, lane);\n", "", 1)],
    "gemm2": [("      tile_mma<MAX_NT2, KS2>(acc2, nt2, s2s, lda_s, wm * 16 + "
               "q, kb, buf,\n                             ldb2, wn * (L / 2), "
               "lane);\n", "", 1)],
    "loads": [("      issue(s + 1, wb[(s + 1) & 1]);\n",
               "      if (s + 1 < 2) issue(s + 1, wb[(s + 1) & 1]);\n", 1)],
    "snake": [("if (SNAKE) {", "if (false) {", 1)],
}
TENSOR_CORES = {
    "gemm1": [("tile_3xtf32<4, KS1>(acc1,", "if (false) tile_3xtf32<4, KS1>(acc1,",
               1),
              ("wgmma_bf16<NH>(", "if (false) wgmma_bf16<NH>(", 1)],
    "gemm2": [("tile_3xtf32<NT2, KS2>(acc2,",
               "if (false) tile_3xtf32<NT2, KS2>(acc2,", 1),
              ("wgmma_bf16<HALF>(", "if (false) wgmma_bf16<HALF>(", 1)],
    "loads": [("    mbar_expect_tx(&full[s % STAGES], 4 * floats);\n",
               "    if (s >= STAGES) {  // no copy: the slot's old slice serves\n"
               "      mbar_expect_tx(&full[s % STAGES], 0);\n      return;\n"
               "    }\n    mbar_expect_tx(&full[s % STAGES], 4 * floats);\n", 1),
              ("    mbar_expect_tx(&full[s % STAGES], bytes);\n",
               "    if (s >= STAGES) {  // no copy: the slot's old slice serves\n"
               "      mbar_expect_tx(&full[s % STAGES], 0);\n      return;\n"
               "    }\n    mbar_expect_tx(&full[s % STAGES], bytes);\n", 1)],
    "snake": [("if (SNAKE) SnakePair(", "if (false) SnakePair(", 1),
              ("if (SNAKE) sp[jt].apply(", "if (false) sp[jt].apply(", 1),
              ("      if (SNAKE) {\n#pragma unroll\n        for (int jt = 0;",
               "      if (false) {\n#pragma unroll\n        for (int jt = 0;", 1)],
}


def main() -> int:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    tree, dest = Path(sys.argv[1]).resolve(), Path(sys.argv[2]).resolve()
    text = (tree / SRC).read_text()
    edits = TENSOR_CORES if "wgmma_bf16" in text else FMA
    for part, changes in edits.items():
        out = dest / part
        shutil.rmtree(out, ignore_errors=True)
        for sub in ("flowhigh_tpu_torch", "scripts"):
            shutil.copytree(tree / sub, out / sub,
                            ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy2(tree / "chip_smoke.py", out / "chip_smoke.py")
        new = text
        for old, rep, count in changes:
            if new.count(old) != count:
                raise SystemExit(f"{part}: {old!r} is not in {tree / SRC} "
                                 f"{count} times")
            new = new.replace(old, rep)
        (out / SRC).write_text(new)
        print(f"{part}: {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
