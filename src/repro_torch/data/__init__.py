from .pipeline import Partition, PipelineState, SyntheticTokens
