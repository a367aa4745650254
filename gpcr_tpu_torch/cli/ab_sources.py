"""Copies of the ring kernels' sources (``csrc/stream_blend.cu``,
``csrc/aligned_blend.cu`` and ``csrc/blend_common.cuh``) with one design
step undone, for the per-step A/B of ``profile_blend --baseline DIR``:

    python -m gpcr_tpu_torch.cli.ab_sources runs/ab
    python -m gpcr_tpu_torch.cli.profile_blend --kernels 2,4 \
        --baseline runs/ab/nocull --baseline runs/ab/dbuf ...

Each step is one edit of ``blend_common.cuh`` (the kernels' own files are
copied as they are); an edit whose text is no longer in the header raises,
so a copy never silently equals this tree:

- ``nocull``: every block's mask bit set, no mask computed;
- ``dbuf``: a double buffer with a CTA barrier after every chunk in place
  of the ring (the serving kernel's scheme), masks as in the ring;
- ``group1``: one alpha at a time in place of four;
- ``ownmask``: each warp computes its own block's masks, no shared pass;
- ``column``: warps sharing a scheduler take the two blocks of one column;
- ``noprefetch``: a stream row's features read only when composited.

(Tiles by ascending id need no copy: ``profile_blend`` times them through
the production wrappers.)
"""

from __future__ import annotations

import argparse
import os
import shutil

from ..ops.cuda_build import CSRC_DIR

FILES = ("stream_blend.cu", "aligned_blend.cu", "blend_common.cuh")


def _sub(old: str, new: str):
    def edit(s: str) -> str:
        if old not in s:
            raise ValueError(f"blend_common.cuh no longer holds: {old[:60]!r}")
        return s.replace(old, new)
    return edit


_GROUP = "constexpr int kGroup = 4;  // visited entries whose alphas overlap"

_DBUF_BODY = '''\
  // double buffer: chunk k + 1 is copied while chunk k is walked, and
  // the CTA meets at a barrier after every chunk
  const WarpPixel wp = ring_pixel(tid < kPix ? tid : 0);
  const int block = ring_block(warp < kWarps ? warp : 0);
  const float px = x0 + (float)wp.lx;
  const float py = y0 + (float)wp.ly;
  if (warp == kWarps) chunks.issue(0, buf, full, lane);
  int k = 0;
  for (; k < nch; ++k) {
    const int st = k & 1;
    const unsigned par = (unsigned)((k >> 1) & 1);
    if (warp == kWarps && k + 1 < nch)
      chunks.issue(k + 1, buf + (size_t)(st ^ 1) * stride, full + (st ^ 1),
                   lane);
    int done_here = 1;
    if (warp < kWarps) {
      unsigned char* stage = buf + (size_t)st * stride;
      const auto v = chunks.view(stage);
      unsigned char* masks = stage + masks_at;
      wd.wait_begin();
      while (!mbar_try_wait(full + st, par)) {
      }
      wd.wait_end();
      wd.chunk(!pb.done);
      int first = 0;
      if (lane == 0) first = atomicMax(claim + st, k + 1) <= k;
      if (__shfl_sync(0xffffffffu, first, 0)) {
        for (int j = lane; j < chunks.n(k); j += 32)
          masks[j] = (unsigned char)v.mask(j, x0, y0);
        __syncwarp();
        if (lane == 0) mbar_arrive(ready + st);
      } else {
        wd.wait_begin();
        while (!mbar_try_wait(ready + st, par)) {
        }
        wd.wait_end();
      }
      if (!__all_sync(0xffffffffu, pb.done)) {
        const int stop =
            walk_chunk<C>(v, masks, chunks.n(k), px, py, block, lane, pb, wd);
        if (stop >= 0) stop_at = k * chunks.chunk + stop;
      }
      done_here = pb.done;
    }
    wd.wait_begin();
    const int n_done = __syncthreads_count(done_here);
    wd.wait_end();
    if (n_done == kRingThreads) { ++k; break; }
  }
  if (warp == kWarps && lane == 0 && k < nch)  // chunk k's copy has landed
    while (!mbar_try_wait(full + (k & 1), (unsigned)((k >> 1) & 1))) {
    }
}

'''


def _dbuf(s: str) -> str:
    a = s.index("  if (warp == kWarps) {  // the producer")
    b = s.index("}  // namespace gpcr", a)
    s = s[:a] + _DBUF_BODY + s[b:]
    return _sub("inline int ring_stages(size_t stride) {\n",
                "inline int ring_stages(size_t stride) {\n  return 2;\n")(s)


def _ownmask(s: str) -> str:
    s = _sub("float px, float py, int block,",
             "float x0, float y0, float px, float py, int block,")(s)
    s = _sub("((masks[jb + lane] >> block) & 1u)",
             "((v.mask(jb + lane, x0, y0) >> block) & 1u)")(s)
    a = s.index("    int first = 0;  // the first warp here computes")
    b = s.index("    if (stop >= 0) stop_at", a)
    call = ("    const int stop = walk_chunk<C>(v, masks, chunks.n(k), x0,"
            " y0, px, py, block, lane, pb, wd);\n")
    return s[:a] + call + s[b:]


STEPS = {
    "nocull": _sub("masks[j] = (unsigned char)v.mask(j, x0, y0);",
                   "masks[j] = 0xffu;"),
    "dbuf": _dbuf,
    "group1": _sub(_GROUP, _GROUP.replace("= 4;", "= 1;")),
    "ownmask": _ownmask,
    "column": _sub("  return warp ^ ((warp >> 2) & 1);\n", "  return warp;\n"),
    "noprefetch": _sub("  static constexpr bool kPrefetch = true;",
                       "  static constexpr bool kPrefetch = false;"),
}


def write(out_dir: str, csrc_dir: str = CSRC_DIR) -> dict:
    """Write ``<out_dir>/<step>/`` for every step; returns {step: dir}."""
    with open(os.path.join(csrc_dir, "blend_common.cuh")) as f:
        header = f.read()
    dirs = {}
    for step, edit in STEPS.items():
        d = os.path.join(out_dir, step)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for name in FILES[:2]:
            shutil.copy(os.path.join(csrc_dir, name), d)
        with open(os.path.join(d, FILES[2]), "w") as f:
            f.write(edit(header))
        dirs[step] = d
    return dirs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", help="directory to write one copy per step into")
    for step, d in write(ap.parse_args(argv).out_dir).items():
        print(step, d)


if __name__ == "__main__":
    main()
