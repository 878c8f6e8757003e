"""``batchnorm_share.train``: the BatchNorm family's kernels over the
traced busy time, whichever backward the trace ran (cuDNN's, or the
port's after cuDNN's forward)."""

import pytest

from perfbench import harness
from perfbench.trace import Summary


def kernel(ts, dur, name):
    return {"cat": "kernel", "ts": ts, "dur": dur, "name": name}


@pytest.mark.parametrize("names", [
    pytest.param(("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float>(int)",
                  "void cudnn::bn_bw_1C11_kernel_new<float>(int)"),
                 id="cudnn"),
    pytest.param(("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float>(int)",
                  "void bn_train::bn_train_dx_kernel<4>(float const*)"),
                 id="port"),
])
def test_share_of_either_route(names):
    reader = harness.load_reader("batchnorm_share.train")
    events = [kernel(0, 1e6, names[0]), kernel(1e6, 2e6, "other"),
              kernel(3e6, 1e6, names[1]),
              kernel(4e6, 1e6, "void cudnn::bn_fw_inf_1C11_kernel_NCHW()")]
    rec = {"entry": "train", "summary": Summary(events, 6.0),
           "kernel_family": harness.kernel_family}
    assert reader.read(rec) == pytest.approx(40.0)
    assert reader.read({**rec, "entry": "eval"}) is None
    rec["summary"] = Summary(events[1:2], 6.0)
    assert reader.read(rec) is None
