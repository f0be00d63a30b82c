from repro_torch.core.adamw import AdamWState, adamw  # noqa: F401
from repro_torch.core.bucketing import (  # noqa: F401
    BucketPlan, build_plan, fused_rownorm_update,
)
from repro_torch.core.dominance import dominance_ratios, global_dominance  # noqa: F401
from repro_torch.core.engine import BucketedState  # noqa: F401
from repro_torch.core.mixed import (  # noqa: F401
    ClipStats, FusedMixedState, MixedState, clip_by_global_norm, is_matrix_param,
    mixed_optimizer, momentum_for_diagnostics,
)
from repro_torch.core.muon import muon, newton_schulz  # noqa: F401
from repro_torch.core.registry import make_optimizer, optimizer_names  # noqa: F401
from repro_torch.core.rmnp import rmnp, rms_lr_scale, row_normalize  # noqa: F401
from repro_torch.core.rules import (  # noqa: F401
    MatrixUpdateRule, make_rule, per_leaf_reference, rule_names,
)
from repro_torch.core.schedule import constant, cosine_with_warmup  # noqa: F401
from repro_torch.core.types import Optimizer, apply_updates, tree_paths  # noqa: F401
