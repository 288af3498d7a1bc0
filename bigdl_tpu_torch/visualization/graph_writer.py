"""TensorBoard graph-view export (counterpart of
`bigdl_tpu/visualization/graph_writer.py`): one events file whose Event
carries a serialized GraphDef, a node per layer, op the layer's class,
inputs the edges (a container's children chain in order)."""

from __future__ import annotations

import time

from bigdl_tpu_torch.visualization.wire import Event, GraphDef, NodeDef


def model_graph_def(module) -> GraphDef:
    """A `GraphDef` describing `module`'s topology: every `Container`'s
    children (`children_in_order`) as a chain, every other module one
    node named by its path of `name`s."""
    gd = GraphDef()
    seen = set()

    def unique(name):
        base = name.replace(" ", "_")
        n, i = base, 1
        while n in seen:
            i += 1
            n = f"{base}_{i}"
        seen.add(n)
        return n

    def add_node(name, op, inputs):
        gd.node.append(NodeDef(name, op, inputs))
        return name

    def emit(m, inputs, prefix):
        """Returns the output node name(s) of `m`."""
        children = m.children_in_order() \
            if hasattr(m, "children_in_order") else None
        if children:
            outs = list(inputs)
            for c in children:
                outs = emit(c, outs, f"{prefix}{c.name}/")
            return outs
        name = getattr(m, "name", type(m).__name__)
        return [add_node(unique(prefix.rstrip("/") or name),
                         type(m).__name__, inputs)]

    inp = add_node(unique("input"), "Placeholder", [])
    emit(module, [inp], "")
    return gd


def save_graph_topology(module, log_path: str) -> str:
    """Write `log_path/...tfevents...` with the model graph; returns the
    directory (point TensorBoard at it)."""
    from bigdl_tpu_torch.visualization.event_writer import EventWriter
    ev = Event(wall_time=time.time(),
               graph_def=model_graph_def(module).SerializeToString())
    w = EventWriter(log_path)
    w.add_event(ev)
    w.close()
    return log_path
