"""Logical-axis sharding of the port: rules, the mesh context, the
parameter helpers and the model-axis collectives (``parallel``)."""
from repro_torch.sharding.context import (  # noqa: F401
    clear_rules,
    constrain,
    get_rules,
    param_shardings,
    set_rules,
    sharding_for_axes,
    spec_for_axes,
)
from repro_torch.sharding.logical import axes_tree, boxed_like, unbox  # noqa: F401
from repro_torch.sharding.rules import (  # noqa: F401
    DECODE_RULES,
    TRAIN_RULES,
    choose_layout,
    complete_rules,
    fsdp_rules,
    make_rules,
    param_rules,
)
