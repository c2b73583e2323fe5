"""Training parity of the vlm family: qwen2-vl-2b at its smoke config, over patch
embeddings with (t, h, w) M-RoPE positions (its token table unused: a
zero grad in both packages): the port's training forward, loss,
grads and train steps against the JAX package's, and remat on and off
bitwise in the port (tests/test_torch_train.py)."""

import test_torch_train as TP

ARCH = "qwen2-vl-2b"
globals().update(TP.parity_tests(ARCH, __file__))

if __name__ == "__main__":
    TP.main([ARCH])
