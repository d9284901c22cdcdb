"""Adaptive compression control plane (the JAX package's control/): in-step
telemetry, pluggable policies, and a decision -> (UnitPlan, step) cache."""
from repro_torch.control.telemetry import (TELEMETRY_SCHEMA_VERSION,
                                           TelemetryState, accumulate,
                                           init_telemetry, measure,
                                           measurement_plan,
                                           payload_bits_per_step, summarize,
                                           to_json, unit_omegas)
from repro_torch.control.policy import (FUSION_LADDER, POLICIES,
                                        RATIO_LADDER, AdaptiveKPolicy,
                                        BitBudgetPolicy, CompressionDecision,
                                        FusionPolicy,
                                        GranularitySwitchPolicy, PerDimRatio,
                                        Policy, StaticPolicy,
                                        VarianceBudgetPolicy, make_policy)
from repro_torch.control.controller import Controller, engine_controller
