// gather_sorted (K2): up to 8 planes of one table of any length s, gathered
// at one index array whose entries are nondecreasing (the positions that
// survive a filter, sorted foreign-key probes):
// out[p][i] = plane[p][clamp(idx[i], 0, s - 1)], planes of 1, 2, 4 or 8
// bytes each (csrc/gather_planes.cuh).
//
// Replaces the TPU kernel `_gather_sorted_i32` / wrapper
// `gather_sorted_planes` of lingodb_tpu/ops/pgather.py. The TPU cannot read
// scattered addresses of its device memory from inside a kernel, so that
// kernel copies an aligned window of the table per index tile into on-chip
// memory and walks it chunk by chunk; an index outside its tile's window
// cannot be served and is counted in an overflow output (`d_chunks`,
// `t_rows` and `conservative` size that window). A GPU thread can load any
// address, so here every index is served straight from global memory and no
// window exists: the overflow output and the window parameters are dropped
// from the port, and the wrapper returns the values alone. Unsorted indices
// are served just as correctly, only with one sector per entry: a wrong
// monotone hint costs time, never a wrong value.
//
// Bound on this card: bytes - 4 per index read, the planes' widths per row
// written, and of the planes the 32-byte sectors that hold a requested
// entry. Two shapes matter:
//   dense (an FK probe, a filter that keeps most rows): neighbouring rows
//       read neighbouring entries, so a warp's loads share sectors. Each
//       thread reads a quad of rows' indices in one 16-byte load and serves
//       all of the call's planes from them (one read of the index),
//       storing 4 elements at a time.
//   sparse (q6's 2 % of lineitem): each requested entry lies in a sector of
//       its own, so the card must move at least 32 bytes per entry and
//       plane (the sector floor), and the time goes to the card's random
//       reads. Where the grid of quads is small against the card
//       (kSplitBlocksPerSM), it has a block per (rows, plane), and each
//       thread takes 4 rows strided by the block, so that every warp-wide
//       load covers 32 neighbouring rows; its 4 loads are issued before its
//       first store. The index is read once per plane (from L2 after the
//       first). One plane a call takes that kernel too.
// The constants were chosen by tools/design_sweep.py --only gathers at
// chip_smoke.py phase 3's shapes (PERF.md section 6): at q6's shape
// (115,319 rows, 7 planes) the strided rows read 0.0198-0.0200 ms on the
// card against 0.0228 with a quad a thread, 0.0225 with a thread for all
// planes; at the dense shapes a quad a thread for all planes is 0.0238 ms
// at C = 2 against 0.0275 with strided rows (NVIDIA H100 80GB HBM3,
// 700.00 W).

#include "gather_planes.cuh"

// desc: the call, packed as gather_planes.cuh describes. One kernel launch.
extern "C" int ldb_gather_sorted(const int64_t* desc) {
  Call c;
  const int bad = parse(desc, &c);
  if (bad) return bad;
  DeviceGuard guard(c.device);
  if (guard.err != cudaSuccess) return -(int)guard.err;
  const int captured = capturing(c.stream);
  if (captured < 0) return captured;
  launch_direct(c);
  return launched(captured);
}
