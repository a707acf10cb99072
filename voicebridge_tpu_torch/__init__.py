"""voicebridge_tpu_torch: the decoding path of voicebridge_tpu in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

wave -> MFCC (kernel ``csrc/mfcc.cu``) -> per-speaker CMVN -> deltas ->
diagonal-GMM log-likelihoods (``csrc/gmm_loglik.cu``) -> exact Viterbi best
path over an HCLG graph (``csrc/viterbi_step.cu``, one launch per window of
frames) -> words.  Every kernel has a plain PyTorch version beside it; a CPU tensor goes
to the plain version, a CUDA tensor to the kernel.  The package stands alone:
it keeps its own numpy host modules (config, utils, models, fst, lm, data,
scoring; copies of the JAX package's under the same relative names) and
imports neither jax nor ``voicebridge_tpu``.
"""

from .config import DecodeOptions, DeltaOptions, FrameOptions, MelOptions, MfccOptions

__all__ = ["DecodeOptions", "DeltaOptions", "FrameOptions", "MelOptions", "MfccOptions"]
