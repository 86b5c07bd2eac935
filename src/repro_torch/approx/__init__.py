"""Approximate-datapath core of the port (``repro.approx`` counterpart)."""
from .quant import QuantParams, calibrate, dequantize, quantize
from .power import (cost_axes_map, network_costs_for_assignment,
                    rel_power_map)
from .objectives import (AtLeast, AtMost, MaxDrop, Objective,
                         UnknownObjectiveError, available_objectives,
                         ensure_objective, get_objective,
                         register_objective, select, value_of)
from .workload import (Workload, as_workload, classification,
                       layer_mult_counts, lm_fidelity)
from .registry import (Datapath, available_datapaths, get_datapath,
                       register_datapath)
from .specs import (BackendSpec, LutBank, MaterializedBackend, PolicyBank,
                    bank_for, canonicalize, clear_materialize_cache,
                    materialize, materialize_cache_stats)
from .backend import MatmulBackend, as_backend, backend_matmul
from .layers import (ApproxPolicy, bank_backend, bank_eval,
                     policy_bank_eval, policy_for_lane, spec_of)
from .resilience import (BankableEval, LayerComponents, all_layers_sweep,
                         can_bank, per_layer_sweep)
from .dse import (DesignPoint, ExploreResult, compose_assignments,
                  explore, explore_heterogeneous, pareto_points,
                  select_multiplier, select_point, verify_assignments)
from .ranking import kendall, per_layer_spearman, rankdata, spearman
from .surrogate import (FEATURE_NAMES, SurrogateConfig,
                        SurrogatePredictor, circuit_features,
                        feature_matrix, fit_surrogate,
                        surrogate_components, train_subset)
from .modules import (EXACT_FAMILIES, FILL_EXACT, MODULE_FAMILIES,
                      ModuleMap, module_of, module_policy_bank,
                      module_sweep_assignments)
from .profiles import (ArchProfile, ModuleRow, profile_architecture,
                       profile_zoo)
