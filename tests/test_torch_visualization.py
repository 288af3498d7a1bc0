"""Port parity: `bigdl_tpu_torch/visualization/` (TensorBoard summaries
with no protobuf package) against `bigdl_tpu/visualization/`.

- The masked CRC32C equals the reference's on known vectors and random
  bytes.
- `wire`'s `Event` (scalar, histogram, file version, graph) serializes to
  the same bytes as the reference's protobuf message, and decodes the
  reference's.
- A port-written events file reads through the reference's `FileReader`
  (scalars) and its protobuf parser (histograms); a reference-written one
  through the port's, scalars and histograms equal.
- `LocalOptimizer` and `DistriOptimizer` write Loss, LearningRate and
  Throughput at each sync point (Loss the step records' losses as
  float32), `Parameters` histograms when the trigger fires (tags the
  reference's tree paths, values the JAX-layout parameters), and the
  validation scores.
- `model_graph_def` of a port `Sequential` names the nodes as the
  reference's of the same model.
"""

import os

import numpy as np
import pytest

import bigdl_tpu.nn as jnn
from bigdl_tpu.native import masked_crc32c as jmasked
from bigdl_tpu.proto import tb_event_pb2, tf_graph_pb2
from bigdl_tpu.visualization import FileReader as JFileReader
from bigdl_tpu.visualization import TrainSummary as JTrainSummary
from bigdl_tpu.visualization import graph_writer as jgraph
from bigdl_tpu.visualization.summary import \
    histogram_event as jhistogram_event
from bigdl_tpu.visualization.summary import scalar_event as jscalar_event
import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.dataset import LocalDataSet, MiniBatch
from bigdl_tpu_torch.interop import params_tree
from bigdl_tpu_torch.observability import InMemorySink, Telemetry
from bigdl_tpu_torch.optim import (SGD, DistriOptimizer, LocalOptimizer,
                                   Top1Accuracy, max_iteration,
                                   several_iteration)
from bigdl_tpu_torch.visualization import (FileReader, TrainSummary,
                                           ValidationSummary,
                                           model_graph_def,
                                           save_graph_topology)
from bigdl_tpu_torch.visualization.record_writer import (crc32c,
                                                         masked_crc32c)
from bigdl_tpu_torch.visualization.summary import (histogram_event,
                                                   scalar_event)
from bigdl_tpu_torch.visualization.wire import Event, GraphDef


def test_crc32c_known_vectors_and_the_reference():
    assert crc32c(b"") == 0
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"\x00" * 32) == 0x8A9136AA
    rs = np.random.RandomState(0)
    for n in (1, 7, 64, 1000):
        data = rs.bytes(n)
        assert masked_crc32c(data) == jmasked(data)
        assert crc32c(data[n // 2:], crc32c(data[:n // 2])) == crc32c(data)


def _histogram_values():
    rs = np.random.RandomState(1)
    return np.concatenate([rs.randn(500) * 0.05, [0.0, 3.5, -1e-9]])


@pytest.mark.parametrize("kind", ["scalar", "histogram", "empty_histogram",
                                  "file_version", "graph"])
def test_events_serialize_to_the_reference_bytes(kind):
    if kind == "scalar":
        ev, jev = scalar_event("Loss", 0.3125, 7), \
            jscalar_event("Loss", 0.3125, 7)
    elif kind in ("histogram", "empty_histogram"):
        vals = _histogram_values() if kind == "histogram" else np.zeros(0)
        ev, jev = histogram_event("w", vals, 3), \
            jhistogram_event("w", vals, 3)
    elif kind == "file_version":
        ev = Event(wall_time=1.5, file_version="brain.Event:2")
        jev = tb_event_pb2.Event(wall_time=1.5, file_version="brain.Event:2")
    else:
        ev = Event(wall_time=2.0, graph_def=b"\x0a\x03abc")
        jev = tb_event_pb2.Event(wall_time=2.0, graph_def=b"\x0a\x03abc")
    jev.wall_time = ev.wall_time  # both stamp time.time()
    assert ev.SerializeToString() == jev.SerializeToString()
    back = Event.FromString(jev.SerializeToString())
    assert back.SerializeToString() == jev.SerializeToString()


def _tags_and_values(events):
    out = []
    for ev in events:
        for v in ev.summary or ():
            h = v.histo
            out.append((ev.step, v.tag, v.simple_value,
                        None if h is None else
                        (h.min, h.max, h.num, h.sum, h.sum_squares,
                         list(h.bucket_limit), list(h.bucket))))
    return out


def _write(summary_cls, d, hist=True):
    s = summary_cls(str(d), "app")
    for step, loss in ((1, 0.75), (2, 0.5), (3, -0.125)):
        s.add_scalar("Loss", loss, step)
    if hist:
        s.add_histogram("w", _histogram_values(), 2)
    s.close()
    return os.path.join(str(d), "app", "train")


def _pb_events(path):
    """Every event of the files under `path`, through the reference's
    TFRecord reader and protobuf parser, as port `Event`s."""
    from bigdl_tpu.native import NativeTFRecordReader
    out = []
    for fname in JFileReader.list_events(path):
        with NativeTFRecordReader(fname) as reader:
            for record in reader:
                out.append(Event.FromString(
                    tb_event_pb2.Event.FromString(record)
                    .SerializeToString()))
    return out


def _port_events(path):
    from bigdl_tpu_torch.visualization.record_writer import read_records
    return [Event.FromString(r) for fname in FileReader.list_events(path)
            for r in read_records(fname)]


def test_event_files_cross_decode(tmp_path):
    port_dir = _write(TrainSummary, tmp_path / "port")
    ref_dir = _write(JTrainSummary, tmp_path / "ref")
    want = [(1, 0.75), (2, 0.5), (3, -0.125)]
    assert JFileReader.read_scalar(port_dir, "Loss") == want
    assert FileReader.read_scalar(ref_dir, "Loss") == want
    # histograms and every other field, both ways
    a, b = _tags_and_values(_pb_events(port_dir)), \
        _tags_and_values(_port_events(ref_dir))
    assert a == b and len(a) == 4
    assert _pb_events(port_dir)[0].file_version == "brain.Event:2"
    (step, h), = FileReader.read_histogram(ref_dir, "w")
    assert step == 2 and h.num == 503 and sum(h.bucket) == 503


def test_corrupt_records_are_refused(tmp_path):
    path = _write(TrainSummary, tmp_path, hist=False)
    (fname,) = FileReader.list_events(path)
    raw = bytearray(open(fname, "rb").read())
    raw[-6] ^= 0xFF
    with open(fname, "wb") as f:
        f.write(raw)
    with pytest.raises(ValueError, match="CRC"):
        FileReader.read_scalar(path, "Loss")


def test_summary_triggers_are_checked(tmp_path):
    s = TrainSummary(str(tmp_path), "app")
    try:
        with pytest.raises(ValueError):
            s.set_summary_trigger("Nope", several_iteration(1))
        trig = several_iteration(2)
        assert s.set_summary_trigger("Parameters", trig) is s
        assert s.get_summary_trigger("Parameters") is trig
        assert s.get_summary_trigger("Loss") is None
    finally:
        s.close()


def _mlp():
    return (nn.Sequential().add(nn.Linear(4, 6, device="cpu"))
            .add(nn.ReLU()).add(nn.Linear(6, 2, device="cpu"))
            .add(nn.LogSoftMax()))


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("loop", ["local", "distri"])
def test_optimizers_write_the_summaries(loop, tmp_path):
    rs = np.random.RandomState(0)
    batches = [MiniBatch(rs.rand(8, 4).astype(np.float32),
                         (rs.randint(0, 2, 8) + 1).astype(np.int64))
               for _ in range(4)]
    model = _mlp()
    if loop == "local":
        opt = LocalOptimizer(model, LocalDataSet(batches),
                             nn.ClassNLLCriterion(), device="cpu")
    else:
        opt = DistriOptimizer(model, LocalDataSet(batches),
                              nn.ClassNLLCriterion(), devices=["cpu"])
    opt.set_optim_method(SGD(learning_rate=0.1))
    opt.set_end_when(max_iteration(6)).set_sync_interval(2)
    sink = InMemorySink()
    opt.set_telemetry(Telemetry(sink, resources=False, flight=False))
    ts = TrainSummary(str(tmp_path), "mlp")
    ts.set_summary_trigger("Parameters", several_iteration(4))
    vs = ValidationSummary(str(tmp_path), "mlp")
    opt.setTrainSummary(ts).setValidationSummary(vs)
    opt.set_validation(several_iteration(3), batches[:2], [Top1Accuracy()])
    seen = {}
    opt.set_iteration_hook(lambda s: seen.setdefault(s["neval"], {
        k: np.array(v) for k, v in _flat(params_tree(model))}))
    opt.optimize()
    ts.close()
    vs.close()
    train = os.path.join(str(tmp_path), "mlp", "train")
    steps = [r for r in sink.records if r["type"] == "step"]
    assert FileReader.read_scalar(train, "Loss") == \
        [(r["step"], float(np.float32(r["loss"]))) for r in steps]
    assert [s for s, _ in FileReader.read_scalar(train, "LearningRate")] \
        == [2, 4, 6]
    assert [v for _, v in FileReader.read_scalar(train, "Throughput")] == \
        [float(np.float32(r["throughput"])) for r in steps]
    # the Parameters histograms at iteration 4, the reference's tags
    tags = [t for t, _ in _flat(params_tree(model))]
    for tag in tags:
        (step, h), = FileReader.read_histogram(train, tag)
        want = seen[4][tag].astype(np.float64)
        assert step == 4 and h.num == want.size
        assert h.min == want.min() and h.max == want.max()
        assert h.sum == pytest.approx(want.sum(), rel=1e-12)
    # the same tags, through the reference's reader
    assert JFileReader.read_scalar(train, "Loss") == \
        FileReader.read_scalar(train, "Loss")
    val = os.path.join(str(tmp_path), "mlp", "validation")
    assert [s for s, _ in FileReader.read_scalar(val, "Top1Accuracy")] \
        == [3, 6]


def test_graph_def_names_nodes_as_the_reference(tmp_path):
    jm = (jnn.Sequential().add(jnn.Linear(4, 6)).add(jnn.ReLU())
          .add(jnn.Linear(6, 2)).add(jnn.LogSoftMax()))
    got = [(n.name, n.op, n.input) for n in model_graph_def(_mlp()).node]
    want = [(n.name, n.op, list(n.input))
            for n in jgraph.model_graph_def(jm).node]
    assert got == want
    path = save_graph_topology(_mlp(), str(tmp_path / "graph"))
    (ev,) = [e for e in _pb_events(path) if e.graph_def is not None]
    parsed = tf_graph_pb2.GraphDef.FromString(ev.graph_def)
    assert [n.name for n in parsed.node] == [g[0] for g in got]
    assert GraphDef.FromString(ev.graph_def).node[1].op == "Linear"
