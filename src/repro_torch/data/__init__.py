"""Training data: a copy of the reference's ``repro/data`` (numpy only),
its imports redirected to the port."""
from repro_torch.data.pipeline import SyntheticTokenPipeline, PipelineStats
