from .engine import Engine, EngineConfig, SessionState, Timings
from .sampling import SamplerParams, probs_from_logits, sample_logits_host, sample_token
