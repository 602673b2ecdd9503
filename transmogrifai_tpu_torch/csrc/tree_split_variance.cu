// tree_split_variance — best variance (regression) split per (lane, node)
// from a level's histograms of (w, w·y, w·y²), over each node's own feature
// subset, and (for fit_trees) the level's tree arrays written in the
// epilogue.
//
// Replaces (JAX): the variance case of transmogrifai_tpu/models/trees.py:
// _fit_tree_compact's scan_chunk body (:331-357), _gain_variance
// (:186-191), _leaf_variance (:212-213) and the level's writes (:365-372,
// :381); likewise the unrolled form's level body.  The body, its design and
// its bound are split_node.cuh's, the gini split's: a variance row is three
// floats a bin, the staging width of a binary gini row, so the impurity is
// the body's template flag and the plan, the layout and the epilogue are
// the gini split's (C = 2, two statistics after the count, one stage a
// group).  This file names the variance kernels and their launch.
#include "split_node.cuh"

template <int HB>
__global__ void __launch_bounds__(256, 4)
    tree_split_variance_kernel(SPLIT_NODE_PARAMS) {
  split_node_body<2, HB, true>(SPLIT_NODE_ARGS);
}

// One variance split level of K lanes x P nodes; returns a cudaError_t.
// The ints are gini_split_plan's at C = 2 (ct = 2); t_value [K, T, 1] takes
// the mean label.  Otherwise as tree_split_gini_launch.
extern "C" int tree_split_variance_launch(
    const void* hist, const void* totals, const void* fmask,
    const void* node_mask, const void* splits, const void* min_inst,
    const void* min_gain, void* out_gain, void* out_feat, void* out_bin,
    void* out_leaf, void* out_thr, void* t_feat, void* t_thr, void* t_leaf,
    void* t_value, void* t_gain, int K, int P, int D, int NB, int C, int ct,
    int hb, int W, int fc, int FPS, int FST, int threads, int T, int offset,
    int smem, void* stream) {
  SplitNodeKernel kern =
      C != 2 || ct != 2 ? nullptr
      : hb == 4 ? tree_split_variance_kernel<4>
      : hb == 6 ? tree_split_variance_kernel<6>
      : hb == 8 ? tree_split_variance_kernel<8>
      : hb == 16 ? tree_split_variance_kernel<16> : nullptr;
  return split_node_launch(kern, hist, totals, fmask, node_mask, splits,
                           min_inst, min_gain, out_gain, out_feat, out_bin,
                           out_leaf, out_thr, t_feat, t_thr, t_leaf, t_value,
                           t_gain, K, P, D, NB, C, ct, hb, W, fc, FPS, FST,
                           threads, T, offset, smem, stream);
}
