"""Training parity of the hybrid family: zamba2-7b at its smoke config (two groups
of the shared attention block with its per-application LoRA on W_q, each
before two Mamba2 layers in the chunked SSD form): the port's training forward, loss,
grads and train steps against the JAX package's, and remat on and off
bitwise in the port (tests/test_torch_train.py)."""

import test_torch_train as TP

ARCH = "zamba2-7b"
globals().update(TP.parity_tests(ARCH, __file__))

if __name__ == "__main__":
    TP.main([ARCH])
