"""Core library of the port: the paper's layer-wise bidirectional
compressed communication (the JAX package's core/__init__.py exports, name
for name): compressors, granularity, UnitPlan, CommSchedule, Algorithm-1
aggregation, the bits accounting and the wire codecs."""
from repro_torch.core.compressors import (Compressor, Identity, RandomK, TopK,
                                          ThresholdV, AdaptiveThreshold,
                                          TernGrad, QSGD, SignSGD,
                                          NaturalCompression, index_bits,
                                          make_compressor,
                                          available_compressors)
from repro_torch.core.granularity import (Granularity, stacked_mask,
                                          unit_dims, num_units,
                                          apply_unitwise,
                                          apply_unitwise_with_state,
                                          apply_unitwise_reference,
                                          apply_unitwise_with_state_reference)
from repro_torch.core.plan import UnitPlan, Bucket, build_plan, plan_unit_dims
from repro_torch.core.schedule import (CommSchedule, Message, FUSE_ALL,
                                       build_schedule, message_wire_bits,
                                       simulate_schedule)
from repro_torch.core.aggregation import (CompressionConfig,
                                          compressed_allreduce,
                                          aggregate_simulated_workers,
                                          no_compression, STRATEGIES)
from repro_torch.core.bits import (comm_report, CommReport,
                                   measured_bits_from_payloads)
from repro_torch.core.wire import (WireCodec, DenseCodec, QSGDCodec,
                                   TernGradCodec, SignSGDCodec, NaturalCodec,
                                   SparseCodec, MessageLayout, has_wire_codec,
                                   message_layouts, to_bf16, to_f32,
                                   wire_codec, word_padding)
