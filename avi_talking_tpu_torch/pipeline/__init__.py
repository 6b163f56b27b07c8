"""The product pipeline: (wav, instruction) -> FLAME coefficients / vertices."""

from .generate import AviTalkingPipeline, PipelineConfig, load_tokenizer
from .postprocess import Intervals, apply_jaw_intervals, butter_lowpass_filtfilt

__all__ = [
    "AviTalkingPipeline",
    "Intervals",
    "PipelineConfig",
    "apply_jaw_intervals",
    "butter_lowpass_filtfilt",
    "load_tokenizer",
]
