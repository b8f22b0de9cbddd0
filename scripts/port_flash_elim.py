#!/usr/bin/env python3
"""Copies of a tree whose kernel F (``csrc/flash_attn.cu``) each drops or
changes one part of its work, for an elimination split of what binds it.

    python3 scripts/port_flash_elim.py TREE DEST

Writes ``DEST/<part>/`` for each part below: ``flowhigh_tpu_torch/`` and
``chip_smoke.py`` of TREE with one edit to the kernel. Each copy keeps the
kernel's loads and barriers unless the part is the loads themselves. Time
the copies beside TREE in one call with ``scripts/port_kernel_ab.py
--flash``; copy TREE's built libraries into
``DEST/<part>/build/flowhigh_tpu_torch/`` first so that only the edited
source rebuilds. The copies other than design steps compute wrong values.

The direct-FMA kernel F (PRs 3-12):
- ``exp``: ``expf`` replaced by a cheap stand-in (one FMA and a max): the
  softmax's exponentials;
- ``pv``: the P.V product's FMAs dropped (and with them its shared
  reads, which the compiler then removes): the second product;
- ``loads``: K and V loaded for the first tile only and served from it
  afterwards (no global loads, no shared stores): the exposed load latency;
- ``seg``: the per-score segment compares dropped.

The tensor-core kernel F (3xTF32 on ``mma.sync``):
- ``exp``: ``exp2f`` replaced by the same stand-in;
- ``pv``: the P.V product's ``mma`` dropped (and with them V's shared
  reads and splits, and P's splits, which the compiler then removes);
- ``loads``: no ``cp.async`` after the ring's first stages: the tiles are
  served from them;
- ``split``: K's and V's values taken as their TF32 hi with a zero lo (no
  split a warp a tile; the three ``mma`` still run);
- ``mma1``: one TF32 product for each f32 one in both products (the hi
  ones; the small ones dropped);
- ``stages3`` (a design step, right values): a three-stage ring.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

SRC = Path("flowhigh_tpu_torch") / "csrc" / "flash_attn.cu"
STAND_IN = ("__device__ __forceinline__ float exp_stand_in(float x) {\n"
            "  return fmaxf(fmaf(x, 0.0625f, 1.f), 0.f);\n}\n\n")
# part: [(text in the kernel, replacement, occurrences)]
DIRECT = {
    "exp": [("namespace {\n", "namespace {\n\n" + STAND_IN, 1),
            ("const float alpha = expf(", "const float alpha = exp_stand_in(",
             1),
            ("s[i][j] = expf(s[i][j] - mu);",
             "s[i][j] = exp_stand_in(s[i][j] - mu);", 1)],
    "pv": [("for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p[i][t], vv[c], "
            "acc[i][c]);", "for (int c = 0; c < 0; ++c) {}", 1)],
    "loads": [("for (int e = tid; e < BN * D / 4; e += NT) {\n      int r, c;\n"
               "      tile_index<D>(e, r, c);\n      float4 kx",
               "for (int e = tid; k0 == 0 && e < BN * D / 4; e += NT) {\n"
               "      int r, c;\n      tile_index<D>(e, r, c);\n      float4 kx",
               1)],
    "seg": [("s[i][j] = sk[j] == sq[i] ? s[i][j] * scale : -INFINITY;",
             "s[i][j] = s[i][j] * scale;", 1)],
}
TENSOR_CORES = {
    "exp": [("namespace {\n", "namespace {\n\n" + STAND_IN, 1),
            ("al[i] = exp2_approx(", "al[i] = exp_stand_in(", 1),
            ("= exp2_approx(si[n]", "= exp_stand_in(si[n]", 2)],
    "pv": [("              mma_tf32_1688(acc, alo[mt], b.h0, b.h1);\n"
            "              mma_tf32_1688(acc, ah[mt], b.l0, b.l1);\n"
            "              mma_tf32_1688(acc, ah[mt], b.h0, b.h1);\n", "", 1)],
    "loads": [("      if (nx < ntiles)\n", "      if (nx < ntiles && nx < STAGES)\n",
               1)],
    "split": [("    split_hi(b0, h0, l0);\n    split_hi(b1, h1, l1);\n",
               "    h0 = __float_as_uint(b0);\n    h1 = __float_as_uint(b1);\n"
               "    l0 = l1 = 0u;\n", 1)],
    "mma1": [("  mma_tf32_1688(d, al[0], b0.h0, b0.h1);\n"
              "  mma_tf32_1688(d, ah[0], b0.l0, b0.l1);\n", "", 1),
             ("  mma_tf32_1688(d, al[1], b1.h0, b1.h1);\n"
              "  mma_tf32_1688(d, ah[1], b1.l0, b1.l1);\n", "", 1),
             ("              mma_tf32_1688(acc, alo[mt], b.h0, b.h1);\n"
              "              mma_tf32_1688(acc, ah[mt], b.l0, b.l1);\n", "", 1)],
    "stages3": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;", 1)],
}


def main() -> int:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    tree, dest = Path(sys.argv[1]).resolve(), Path(sys.argv[2]).resolve()
    text = (tree / SRC).read_text()
    edits = TENSOR_CORES if "mma_tf32_1688" in text else DIRECT
    for part, changes in edits.items():
        out = dest / part
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(tree / "flowhigh_tpu_torch", out / "flowhigh_tpu_torch",
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
