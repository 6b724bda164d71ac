from repro_torch.sharding.rules import (NamedSharding, constrain,
                                        current_mesh, current_rules,
                                        logical_to_spec, set_mesh_and_rules,
                                        use_mesh)
from repro_torch.sharding.api import (activation_rules, param_shardings,
                                      tree_shardings)

__all__ = ["NamedSharding", "constrain", "current_mesh", "current_rules",
           "logical_to_spec", "set_mesh_and_rules",
           "use_mesh", "activation_rules", "param_shardings",
           "tree_shardings"]
