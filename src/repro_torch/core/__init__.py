from repro_torch.core.mixed import (  # noqa: F401
    FusedMixedState, MixedState, clip_by_global_norm, is_matrix_param, mixed_optimizer,
)
from repro_torch.core.registry import make_optimizer, optimizer_names  # noqa: F401
from repro_torch.core.rmnp import rmnp, rms_lr_scale, row_normalize  # noqa: F401
from repro_torch.core.schedule import constant, cosine_with_warmup  # noqa: F401
from repro_torch.core.types import Optimizer, apply_updates, tree_paths  # noqa: F401
