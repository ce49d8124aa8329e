// K6dm: K6d (fwbw_backward.cu, the grouped backward with its betas stored)
// with the 4096 states split over M = 2 .. 64 ranks: the legacy EM round's
// rows off the CLI priors under nanocall_tpu/parallel/mesh.py:126
// shard_train_inputs (parallel/statepar.py drives it after K4m).
//
// Replaces the backward scan of nanocall_tpu/ops/hmm.py fwbw_grouped
// (:1016-1034) under that placement.  The kernel is K5m's
// (em_backward.cu em_backward_wave_kernel), its BETAS instances: K5m's
// beta step on the rank's slice and its two exchanges a step (the ranks'
// partial maxima of g = em(t+1) + beta, then the sums of their own blocks
// of 4 and 16 states), with no statistics, each step's beta of the rank's
// states stored into its (B, T, W) slice.  They are built here, in a
// translation unit of their own, so that K5m's instances in em_backward.cu
// keep their SASS (tools/torch_sass_diff.py): with both sets in one unit
// the compiler allocated one of K5m's instances differently.
//
// What bounds it: K5m's exchanges, two a step, which its beta step leaves
// less work to hide (K6d's step for W states on W / 4 threads); the betas'
// bytes are K6d's bound.
//
// Build with -fmad=false, as em_backward.cu: the kernel is bit-identical
// to fwbw_backward_wave_plain in nanocall_tpu_torch/ops/em.py and to
// fwbw_grouped_backward_plain on the card.

#define NC_K6DM
#include "em_backward.cu"
