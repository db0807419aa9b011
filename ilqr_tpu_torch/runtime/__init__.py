"""Native (C++) runtime components (counterpart of ``ilqr_tpu/runtime``):
trajectory I/O, ``runtime/native/trajio.cpp``, built with g++ at first use
into ``build/ilqr_tpu_torch/runtime/`` and bound with ctypes
(:mod:`ilqr_tpu_torch.runtime.trajio`). Its one consumer,
``utils/io.write_trajectory_csv``, falls back to Python where the library
cannot be built."""
