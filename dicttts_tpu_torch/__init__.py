"""PyTorch/CUDA port of ``dicttts_tpu`` (Dict-TTS), for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module
layout (``ops/seq.py``, ``models/layers.py``, ``models/dict_encoder.py``,
...) and keeps its feature-last ``[B, T, C]`` layout at every public
function so the two can be compared tensor for tensor. It imports torch
and numpy (PyYAML for configs, jieba for tone sandhi where it is
installed), never JAX or ``dicttts_tpu``. The three S2PA Pallas kernels
are hand-written CUDA C++ (``csrc/``), built with plain ``nvcc`` at first
use and bound with ``ctypes`` (``ops/cuda_build.py``).

Entry points: ``dicttts_tpu_torch.infer.DictTTSInferencer`` (Chinese text
-> wav), ``dicttts_tpu_torch.serve.DictTTSServer`` (word ids -> wav) and
``python -m dicttts_tpu_torch.run`` (train, or ``--infer`` a test split).
"""
