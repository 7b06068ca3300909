from xotorch_tpu_torch.inference.native.engine import NativeSidecarInferenceEngine

__all__ = ["NativeSidecarInferenceEngine"]
