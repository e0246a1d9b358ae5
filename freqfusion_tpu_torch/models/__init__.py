"""Twin of ``freqfusion_tpu/models``: the experts, the fusion heads and their variants.

Experts (frozen at train time):
- ``nafnet.NAFNetSR``: NAFNet-64 with a bicubic x4 pre-upsample
- ``dat.DAT``: Dual Aggregation Transformer
- ``hat.HAT``: Hybrid Attention Transformer (HAT-L)
- ``mambair.MambaIR``: state-space SR with a chunked selective scan (vestigial in the
  reference, which needs mamba_ssm's CUDA kernels)

Fusion:
- ``fusion.FusionHead``: the shipped CompleteEnhancedFusionSR head
- ``fusion_v2.FusionHeadV2``: the compact alternate head
- ``fusion_variants``: FrequencyAwareFusion / MultiFusionSR / MultiResolutionFusion /
  EnhancedMultiFusionSR baselines
- ``experts.ExpertEnsemble`` / ``experts.FreqFusionSR``: the live composition
- ``tsdsr``: the optional DiT diffusion refinement and CompleteSRPipeline, over the SD VAE
  codec of ``vae``
"""
