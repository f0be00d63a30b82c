from repro_torch.models.model import (  # noqa: F401
    build_param_specs, forward, init_params, loss_fn, plan_stack,
)
