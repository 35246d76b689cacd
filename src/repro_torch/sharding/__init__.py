"""Work placement across cards.

 - rules.py  : logical parameter axes -> mesh placements (the LLM mesh)
 - vertex.py : the scheduler's vertex (candidate-subset) axis
 - cells.py  : the cell axis of a sweep of whole simulations
"""
from repro_torch.sharding.rules import (
    AxisRules,
    DEFAULT_RULES,
    ShardSpec,
    activation_specs,
    cache_pspec,
    param_pspecs,
    translate,
)
from repro_torch.sharding.vertex import (
    VERTEX_AXIS,
    max_vertex_shards,
    pad_rows_to_multiple,
    vertex_devices,
)
