"""Sketch ops, their kernels, and the SketchBundle that composes them."""

from .countmin import CountMin, cms_init, cms_merge, cms_query, cms_update
from .entropy import EntropySketch, entropy_estimate, entropy_init, entropy_merge, entropy_update
from .hashing import fmix32, fold64_to_32, multiply_shift, row_hashes
from .hll import HLL, hll_estimate, hll_init, hll_merge, hll_update
from .invertible import InvSketch, inv_init, inv_merge, inv_update
from .kernels import fused_planes, fused_sketch_planes, histogram
from .quantiles import DDSketch, dd_init, dd_merge, dd_quantile, dd_update
from .sketches import (SketchBundle, bundle_digest, bundle_from_numpy,
                       bundle_ingest_step, bundle_init, bundle_merge, bundle_to_numpy,
                       bundle_update, bundle_update_fused, decode_digest)
from .topk import TopK, topk_init, topk_merge, topk_update, topk_values

__all__ = [
    "CountMin", "cms_init", "cms_merge", "cms_query", "cms_update",
    "EntropySketch", "entropy_estimate", "entropy_init", "entropy_merge", "entropy_update",
    "fmix32", "fold64_to_32", "multiply_shift", "row_hashes",
    "HLL", "hll_estimate", "hll_init", "hll_merge", "hll_update",
    "InvSketch", "inv_init", "inv_merge", "inv_update",
    "fused_planes", "fused_sketch_planes", "histogram",
    "DDSketch", "dd_init", "dd_merge", "dd_quantile", "dd_update",
    "SketchBundle", "bundle_digest", "bundle_from_numpy",
    "bundle_ingest_step", "bundle_init", "bundle_merge", "bundle_to_numpy",
    "bundle_update", "bundle_update_fused", "decode_digest",
    "TopK", "topk_init", "topk_merge", "topk_update", "topk_values",
]
