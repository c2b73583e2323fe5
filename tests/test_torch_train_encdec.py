"""Training parity of the encdec family: seamless-m4t-medium at its smoke config
(a bidirectional encoder over frame embeddings, a causal decoder
cross-attending it): the port's training forward, loss,
grads and train steps against the JAX package's, and remat on and off
bitwise in the port (tests/test_torch_train.py)."""

import test_torch_train as TP

ARCH = "seamless-m4t-medium"
globals().update(TP.parity_tests(ARCH, __file__))

if __name__ == "__main__":
    TP.main([ARCH])
