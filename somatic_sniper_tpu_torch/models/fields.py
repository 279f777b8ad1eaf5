"""Field order of the compacted result rows, without any tensor code.

``models.somatic`` builds the rows on the device and ``runner`` decodes
them on the host; the all-host exact run decodes the native scorer's
rows in the same order and must not import torch to learn it, so the
tuple lives here and ``models.somatic`` re-exports it.
"""

# host-side field order of the compacted rows (the JAX package's order,
# somatic_sniper_tpu/models/somatic.py:279-285); the leading column
# is the batch index of each emitted site
COMPACT_FIELDS = (
    "tumor_gt", "normal_gt", "tumor_cnsq", "normal_cnsq",
    "tumor_vaq", "normal_vaq", "somatic_score",
    "joint_tumor_gt", "joint_normal_gt", "joint_cnsq",
    "tumor_status", "normal_status", "tumor_eff_gt", "normal_eff_gt",
    "tumor_depth", "normal_depth",
)
