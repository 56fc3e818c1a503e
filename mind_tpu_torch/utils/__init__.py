from mind_tpu_torch.utils.metrics import PhaseTimer, Metrics, profile_trace
