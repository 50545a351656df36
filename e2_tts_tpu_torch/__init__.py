"""e2_tts_tpu_torch — E2-TTS in PyTorch with hand-written CUDA kernels for
the NVIDIA H100 (sm_90a).

A port of the JAX package `e2_tts_tpu`, which stays beside it as the
reference. The layout mirrors the JAX package (`models/`, `ops/`, `text/`,
`utils/`, `training/`, `vocoder/`) so each module has an obvious
counterpart. The port covers zero-shot serving from a raw waveform
(`E2TTS.sample`: the mel frontend `MelSpec`, the `DurationPredictor` when no
duration is given, the sampler, the `Vocos` vocoder, WAV files), the
training stack (`E2TTS.forward`'s flow-matching loss on mels or raw waves;
`E2Trainer` with ADOPT, clip, EMA, gradient accumulation, the duration
predictor's side loss or its own training, atomic checkpoints with
auto-resume, TensorBoard and a profiler window; `HFDataset` with
resampling, and background prefetch), the dual-stream `Transformer`, and
the kernels on those paths: packed and (b, h, n, dh) flash attention
forward and backward with the backward's delta pre-pass, the two
hyper-connection width connections (and their save-state variants) and
GEGLU, each forward and backward, and the fused log-mel frontend. Every
constructor option of the JAX package runs: the frequency axis
(`num_freq_tokens`), `concat_cond`, `interpolated_text`, the FANformer
input map, selective remat, the adaptive ODE solvers, `scan_layers` (the
JAX package's stacked layer layout through the weight bridge), the Vocos,
tokenizer and feedforward options. Data parallelism (`parallel/`: DDP or
FSDP2 over torch.distributed, a step of the global batch), tensor
parallelism (`parallel/tp.py`: heads and GEGLU columns over a `model` axis)
and sequence parallelism (`parallel/sp.py`: ring attention over a `seq`
axis, `E2Trainer(sequence_parallel=P)`) are ported.

Entry points run on the GPU unless the caller passes `device='cpu'`; the
CPU path uses each kernel's plain PyTorch version and exists for tests.

Imports are lazy so that importing the package pulls in nothing heavy.
"""

_EXPORTS = {
    'Transformer': 'e2_tts_tpu_torch.models.transformer',
    'E2TTS': 'e2_tts_tpu_torch.models.e2tts',
    'DurationPredictor': 'e2_tts_tpu_torch.models.duration',
    'MelSpec': 'e2_tts_tpu_torch.ops.mel',
    'Vocos': 'e2_tts_tpu_torch.vocoder.vocos',
    'E2Trainer': 'e2_tts_tpu_torch.training.trainer',
    'EMA': 'e2_tts_tpu_torch.training.ema',
    'Adopt': 'e2_tts_tpu_torch.training.adopt',
    'HFDataset': 'e2_tts_tpu_torch.training.data',
}

__all__ = list(_EXPORTS)

__version__ = '0.1.0'


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        module = importlib.import_module(_EXPORTS[name])
        return getattr(module, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
