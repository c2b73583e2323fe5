"""Training parity of the ssm family: xlstm-125m at its smoke config (an mLSTM block
in its chunked form, an sLSTM block scanned over the sequence): the port's training forward, loss,
grads and train steps against the JAX package's, and remat on and off
bitwise in the port (tests/test_torch_train.py)."""

import test_torch_train as TP

ARCH = "xlstm-125m"
globals().update(TP.parity_tests(ARCH, __file__))

if __name__ == "__main__":
    TP.main([ARCH])
