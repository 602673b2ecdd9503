// tree_split_gini — best gini split per (lane, node) from a level's
// histograms, over each node's own feature subset, and (for fit_trees) the
// level's tree arrays written in the epilogue.
//
// Replaces (JAX): the gini case of transmogrifai_tpu/models/trees.py:
// _fit_tree_compact's scan_chunk body (:331-357), _gain_gini (:194-199),
// _leaf_gini (:216-217) and the level's writes (:365-372, :381).  The body,
// its design and its bound are split_node.cuh's (shared with
// tree_split_variance.cu); this file names the gini kernels and their
// launch.
#include "split_node.cuh"

// CT classes a stage, HB bins a lane; up to 8 classes four blocks an SM
// (measured: latency-bound, more warps beat spills), past that one
template <int CT, int HB>
__global__ void __launch_bounds__(256, CT <= 4 ? 4 : 1)
    tree_split_gini_kernel(SPLIT_NODE_PARAMS) {
  split_node_body<CT, HB, false>(SPLIT_NODE_ARGS);
}

// One gini split level of K lanes x P nodes over C >= 2 classes; returns a
// cudaError_t.  ct classes a stage (2, 4 or 8: a template), hb bins a lane
// (4, 6, 8 or 16: a template), W warps a node (1, 2, 4 or 8) of fc features
// each, FPS features a group, FST floats a staged feature row (= 1 mod 32),
// ``threads`` a block (a multiple of 32·W, at most 256), ``smem`` bytes of
// dynamic shared memory (each warp's two slices of FPS rows and two group
// lists of FPS ints).  t_feat .. t_value (null: the dict form only) are
// fit_trees' [K, T] arrays (t_value [K, T, C]), written at columns offset ..
// offset+P-1; t_gain [K, D] (null: no gain sums) takes the split nodes'
// gains (split_level.cuh's second kernel).  models/tree_kernels.py:
// gini_split_plan gives every int.
extern "C" int tree_split_gini_launch(
    const void* hist, const void* totals, const void* fmask,
    const void* node_mask, const void* splits, const void* min_inst,
    const void* min_gain, void* out_gain, void* out_feat, void* out_bin,
    void* out_leaf, void* out_thr, void* t_feat, void* t_thr, void* t_leaf,
    void* t_value, void* t_gain, int K, int P, int D, int NB, int C, int ct,
    int hb, int W, int fc, int FPS, int FST, int threads, int T, int offset,
    int smem, void* stream) {
  SplitNodeKernel kern = nullptr;
#define GINI_K(CT_)                                               \
  kern = hb == 4 ? tree_split_gini_kernel<CT_, 4>                 \
         : hb == 6 ? tree_split_gini_kernel<CT_, 6>               \
         : hb == 8 ? tree_split_gini_kernel<CT_, 8>               \
         : hb == 16 ? tree_split_gini_kernel<CT_, 16> : nullptr
  if (ct == 2) GINI_K(2);
  else if (ct == 4) GINI_K(4);
  else if (ct == 8) GINI_K(8);
#undef GINI_K
  return split_node_launch(kern, hist, totals, fmask, node_mask, splits,
                           min_inst, min_gain, out_gain, out_feat, out_bin,
                           out_leaf, out_thr, t_feat, t_thr, t_leaf, t_value,
                           t_gain, K, P, D, NB, C, ct, hb, W, fc, FPS, FST,
                           threads, T, offset, smem, stream);
}
