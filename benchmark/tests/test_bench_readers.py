"""Every per-layer reader on synthetic traces, spans and events, against numbers
worked out by hand."""
import pytest

from benchmark import flops, traces
from benchmark.spec import Spec
from benchmark.tests.tiny import ROOT

PEAKS = {'bf16': 1e15, 'tf32': 5e14, 'int8': 2e15, 'f32': 6e13, 'memory_bytes_per_s': 3e12}
QRCAN = {'reference': 'qrcan', 'sizes': {'n_resgroups': 10, 'n_resblocks': 20,
                                         'n_feats': 64, 'reduction': 16, 'scale': 4,
                                         'num_metadata': 10}}
EDSR = {'reference': 'edsr', 'sizes': {'num_blocks': 32, 'num_features': 256,
                                       'res_scale': 0.1, 'scale': 4}}
TRACE = {'window': (10.0, 20.0),
         'device': [(9.0, 11.0, 'k1'), (10.5, 12.0, 'k2'), (15.0, 16.0, 'k1'),
                    (19.5, 21.0, 'k3')],
         'host': [(10.0, 20.0, traces.STRETCH), (12.0, 15.5, 'aten::copy_'),
                  (11.0, 19.0, 'outer'), (16.0, 19.5, 'aten::cat')]}


def reader(name):
    return Spec(ROOT).reader(name)


def ctx(job='eval', **kw):
    base = {'job': job, 'peaks': PEAKS, 'config': QRCAN, 'traffic': {'peak': 'bf16'},
            'facts': {'lr_side': 128}, 'probes': {}, 'rate': 100.0, 'trace': TRACE,
            'stretch_s': 4.0}
    base.update(kw)
    return base


def test_trace_arithmetic():
    # busy: [10, 12] + [15, 16] + [19.5, 20] = 3.5 s of a 10 s window
    assert traces.busy_s(TRACE) == pytest.approx(3.5)
    assert traces.window_s(TRACE) == 10.0
    assert traces.device_ops(TRACE) == [['k1', 3.0], ['k2', 1.5], ['k3', 1.5]]
    gaps = dict(traces.idle_gaps(TRACE))
    # gap [12, 15] (mid 13.5: copy_ inside outer), [16, 19.5] (mid 17.75: cat)
    assert gaps == {'aten::copy_': pytest.approx(3.0), 'aten::cat': pytest.approx(3.5)}


def test_idle_share_readers():
    assert reader('idle_share.eval').read(ctx()) == pytest.approx(65.0)
    assert reader('idle_share.train').read(ctx()) is None
    assert reader('idle_share.train').read(ctx('train')) == pytest.approx(65.0)
    assert reader('idle_share.eval').read(ctx(trace=dict(TRACE, device=[]))) is None


def test_mfu_readers():
    per_image = flops.forward_flops('qrcan', QRCAN['sizes'], 128)
    assert reader('mfu.eval').read(ctx()) == pytest.approx(100 * per_image * 100 / 1e15)
    per_crop = flops.train_flops('edsr', EDSR['sizes'], 64)
    train = ctx('train', config=EDSR, traffic={'peak': 'tf32'}, facts={'lr_side': 64})
    assert reader('mfu.train').read(train) == pytest.approx(100 * per_crop * 100 / 5e14)
    assert reader('mfu.eval').read(ctx(peaks=None)) is None


def test_span_readers():
    spans = ctx(probes={'step_spans': {'seconds': [1.0, 1.5]}})
    assert reader('protocol_overhead_share.eval').read(spans) == pytest.approx(37.5)
    waits = ctx('train', probes={'loader_wait': {'seconds': [0.2, 0.2]}})
    assert reader('loader_wait_share.train').read(waits) == pytest.approx(10.0)
    assert reader('loader_wait_share.train').read(ctx('train')) is None


def test_event_readers():
    fwd = ctx(probes={'forward_events': [{'ms': 30.0, 'images': 8},
                                         {'ms': 34.0, 'images': 8}]})
    assert reader('forward_ms_per_img.eval').read(fwd) == pytest.approx(4.0)
    call = {'ms': 0.05, 'shape': (8, 64, 128, 128), 'itemsize': 2, 'gate': True}
    ca = ctx(probes={'ca_events': [call, call]})
    bound = 2 * flops.ca_bytes(8, 128, 128, 64, 2, 16, gate=True) / 3e12
    assert reader('ca_roofline.eval').read(ca) == pytest.approx(100 * bound / 1e-4)
    int8 = ctx(probes={'int8_events': [{'ms': 250.0, 'images': 8}]})
    layers = flops.convs('qrcan', QRCAN['sizes'], 128)
    bound = flops.conv_bound_s(layers, 8, 1, 2, 2e15, 3e12)
    assert reader('int8_roofline.eval').read(int8) == pytest.approx(100 * bound / 0.25)
    assert reader('int8_roofline.eval').read(ctx()) is None
