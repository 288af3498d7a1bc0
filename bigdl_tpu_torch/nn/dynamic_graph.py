"""Dynamic graph execution: TF1-style control flow, `Switch` / `Merge`
and loops (counterpart of `bigdl_tpu/nn/dynamic_graph.py`).

The reference's `DynamicGraph` runs a graph with data-dependent control
flow op by op: a scheduler fires nodes as their inputs become ready, a
`SwitchOps` sends a dead token (`DEAD`) down its untaken port, a
`MergeOps` fires on its first live input, and `Enter` / `Exit` /
`NextIteration` run loop bodies under frames (`FrameManager`). The host
makes every control decision there, and so it does here: `Scheduler` and
`FrameManager` are the reference's pure-Python bookkeeping, and each
fired node is a call of its module on the card (or the CPU). A
`SwitchOps` whose predicate lies on a device reads it back to the host,
one synchronisation a decision, counted in `SwitchOps.host_syncs`.

Build with the node DSL of `nn.Graph`; a loop's back edge is appended to
its `MergeOps` node's inputs (`merge.prev.append(next_iteration)`), and
`switch_port(consumer, switch, port)` records which of a Switch's outputs
(0 false, 1 true) a consumer reads. Graphs without control ops belong in
`nn.Graph`.

Children are registered under their node keys in the reference's
reverse-reach order (`exec_order`: the outputs first, then what they
read). The JAX tree of a `DynamicGraph` holds only the nodes with
parameters; the interop and the model files pair the port's
parameter-holding nodes with it (`interop/jax_params.py`). A model file
of a `DynamicGraph` has no field for the Switch ports, so it is written
as the reference writes it and refused on load
(`serialization/module_serializer.py`).
"""

from __future__ import annotations

import copy
import itertools
from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from bigdl_tpu_torch.nn.containers import Container, Graph
from bigdl_tpu_torch.nn.module import Module, Node
from bigdl_tpu_torch.utils.table import Table


class _Dead:
    """The dead token TF1 executors propagate down untaken branches."""

    def __repr__(self):
        return "<dead>"


DEAD = _Dead()


# ------------------------------------------------------------ control ops
class ControlOps(Module):
    """The control ops' marker base."""


class SwitchOps(ControlOps):
    """switch(T(data, pred)) -> T(false_out, true_out): the untaken port
    is `DEAD`; a dead input kills both ports. A predicate on a device is
    read back to the host (`SwitchOps.host_syncs` counts those reads)."""

    host_syncs = 0

    def forward(self, input):
        data, pred = input[1], input[2]
        if data is DEAD or pred is DEAD:
            return Table(DEAD, DEAD)
        if isinstance(pred, torch.Tensor) and pred.device.type != "cpu":
            SwitchOps.host_syncs += 1
        taken = bool(pred)
        return Table(DEAD if taken else data, data if taken else DEAD)


class MergeOps(ControlOps):
    """Fires on the first live input; its value is that input's."""

    def forward(self, input):
        for v in list(input):
            if v is not DEAD:
                return v
        return DEAD


class Enter(ControlOps):
    """Brings a value into the loop frame `frame`."""

    def __init__(self, frame: str = "", name: Optional[str] = None):
        super().__init__(name)
        self.frame = frame

    def forward(self, input):
        return input


class Exit(ControlOps):
    """Leaves the loop frame with the final value. The `Scheduler` holds
    an Exit back until its input is live."""

    def forward(self, input):
        return input


class NextIteration(ControlOps):
    """Feeds a value to the next loop iteration (the back edge)."""

    def forward(self, input):
        return input


class LoopCondOps(ControlOps):
    """Marks the loop predicate."""

    def forward(self, input):
        return input


class ControlTrigger(ControlOps):
    """A control-dependency join: fires when any input arrives, with an
    empty `Table`."""

    def forward(self, input):
        return Table()


class _Frame:
    """One loop frame: its Merges (the loop variables), back edges, member
    nodes (re-fired every iteration)."""

    def __init__(self, name: str):
        self.name = name
        self.merges: List[Node] = []
        self.back_edges: List[Tuple[Node, Node]] = []  # (next_iter, merge)
        self.members: Set[int] = set()


def _successors(nodes: Sequence[Node]) -> Dict[int, List[Node]]:
    succ: Dict[int, List[Node]] = {}
    for n in nodes:
        for p in n.prev:
            succ.setdefault(id(p), []).append(n)
    return succ


class FrameManager:
    """Loop-frame bookkeeping: groups the loop Merges into frames (keyed
    by the `LoopCondOps` that drives their Switches, else the Enter's
    frame name), walks each frame's members (what an iteration re-fires)
    and stops the walk at the frame's own Exits, so an outer walk passes
    through an inner loop."""

    def __init__(self, nodes: Sequence[Node]):
        succ = _successors(nodes)
        frames: Dict[object, _Frame] = {}
        for n in nodes:
            if not isinstance(n.module, MergeOps):
                continue
            nis = [p for p in n.prev if isinstance(p.module, NextIteration)]
            if not nis:
                continue
            # the frame is the LoopCond driving this merge's Switch: two
            # independent loops never share one (their names may both be
            # "" in hand-built graphs)
            key: object = None
            for s in succ.get(id(n), []):
                if isinstance(s.module, SwitchOps) and len(s.prev) > 1:
                    cand = s.prev[1]
                    if isinstance(cand.module, LoopCondOps):
                        key = id(cand)
                        break
            if key is None:
                enters = [p for p in n.prev if isinstance(p.module, Enter)]
                key = enters[0].module.frame if enters and \
                    enters[0].module.frame else id(n)
            fr = frames.setdefault(key, _Frame(str(key)))
            fr.merges.append(n)
            fr.back_edges.extend((ni, n) for ni in nis)
        self.frames = list(frames.values())

        # a frame's own Exits: an Exit fed (through at most a few hops) by
        # a Switch whose data input is one of the frame's Merges
        for fr in self.frames:
            merge_ids = {id(m) for m in fr.merges}
            own_exits: Set[int] = set()
            for n in nodes:
                if not isinstance(n.module, Exit):
                    continue
                seen: Set[int] = set()
                stack = list(n.prev)
                hops = 0
                while stack and hops < 8:
                    p = stack.pop()
                    hops += 1
                    if id(p) in seen:
                        continue
                    seen.add(id(p))
                    if isinstance(p.module, SwitchOps):
                        if p.prev and id(p.prev[0]) in merge_ids:
                            own_exits.add(id(n))
                        break
                    stack.extend(p.prev)
            # members: reachable from the frame's merges, stopping at (and
            # including) its own Exits
            stack = list(fr.merges)
            while stack:
                n = stack.pop()
                if id(n) in fr.members:
                    continue
                fr.members.add(id(n))
                if id(n) in own_exits:
                    continue
                stack.extend(succ.get(id(n), []))

    @property
    def has_loops(self) -> bool:
        return bool(self.frames)


class Scheduler:
    """A ready-queue executor with dead-token propagation. One `run` is
    one forward; a loop frame re-fires its members until its predicate
    goes false. `MAX_ITERATIONS` bounds the loop iterations of a run."""

    MAX_ITERATIONS = 1_000_000

    def __init__(self, nodes: Sequence[Node], frames: FrameManager):
        self.nodes = list(nodes)
        self.frames = frames

    def run(self, fire, outputs: Sequence[Node]):
        """`fire(node, values) -> value` runs one node given the values
        produced so far (keyed by node id); firing a node enqueues the
        consumers it may have unblocked. Returns the values."""
        succ = _successors(self.nodes)
        values: Dict[int, object] = {}
        q = deque(n for n in self.nodes if self._ready(n, values))
        iterations = 0
        while True:
            while q:
                n = q.popleft()
                if id(n) in values or not self._ready(n, values):
                    continue
                values[id(n)] = fire(n, values)
                for s in succ.get(id(n), []):
                    if id(s) not in values and self._ready(s, values):
                        q.append(s)
            if all(id(o) in values and values[id(o)] is not DEAD
                   for o in outputs):
                break
            if self._advance_frame(values):
                iterations += 1
                if iterations > self.MAX_ITERATIONS:
                    raise RuntimeError("loop exceeded MAX_ITERATIONS")
                q = deque(n for n in self.nodes
                          if id(n) not in values and self._ready(n, values))
                continue
            stuck = [n.module.name for n in self.nodes
                     if id(n) not in values]
            raise RuntimeError(
                f"dynamic graph deadlock; unfired nodes: {stuck[:10]}")
        return values

    def _ready(self, node: Node, values) -> bool:
        if isinstance(node.module, MergeOps):
            # fires on any live input (TF1 Merge semantics)
            return any(id(p) in values and values[id(p)] is not DEAD
                       for p in node.prev) or \
                all(id(p) in values for p in node.prev)
        if not all(id(p) in values for p in node.prev):
            return False
        if isinstance(node.module, Exit):
            # an Exit produces nothing until the loop delivers a live value
            return all(values[id(p)] is not DEAD for p in node.prev) and \
                not self._port_dead(node, values)
        return True

    def _port_dead(self, node: Node, values) -> bool:
        """Whether the node's recorded Switch port carries `DEAD`."""
        ports = getattr(node, "_switch_ports", None)
        if not ports:
            return False
        for p in node.prev:
            port = ports.get(id(p))
            if port is None:
                continue
            v = values.get(id(p))
            if isinstance(v, Table) and v[port + 1] is DEAD:
                return True
        return False

    def _advance_frame(self, values) -> bool:
        """Start the next iteration of the innermost stalled frame: clear
        its members and reseed its Merges from the live back edges."""
        candidates = []
        for fr in self.frames.frames:
            back_vals = [(ni, m) for ni, m in fr.back_edges
                         if id(ni) in values]
            if len(back_vals) != len(fr.back_edges):
                continue  # this frame's iteration has not finished
            live = [(ni, m) for ni, m in back_vals
                    if values[id(ni)] is not DEAD]
            if live:
                candidates.append((fr, live))
        if not candidates:
            return False
        # the innermost: the smallest membership (an outer frame's walk
        # holds every inner frame's nodes)
        fr, live = min(candidates, key=lambda c: len(c[0].members))
        carried = {id(m): values[id(ni)] for ni, m in live}
        for n in self.nodes:
            if id(n) in fr.members:
                values.pop(id(n), None)
        values.update(carried)
        return True


class DynamicGraph(Graph):
    """A graph that executes control ops, built with the node DSL of
    `Graph`; loop back edges (NextIteration -> Merge) are allowed. The
    input is one activity, or a `Table` or list of them (one an input
    node); the output one activity, or a `Table` of them.

        x, p = InputNode(), InputNode()
        sw = SwitchOps().inputs(x, p)
        t = switch_port(MulConstant(2.0).inputs(sw), sw, 1)
        f = switch_port(AddConstant(10.0).inputs(sw), sw, 0)
        g = DynamicGraph([x, p], [MergeOps().inputs(t, f)])
        g(T(torch.tensor([3.0]), torch.tensor(True)))   # tensor([6.])
    """

    def __init__(self, inputs: Sequence[Node], outputs: Sequence[Node],
                 name: Optional[str] = None):
        # not Graph.__init__: its topological sort refuses the back edges
        Container.__init__(self, name)
        self.input_nodes = list(inputs)
        self.output_nodes = list(outputs)
        self.exec_order = self._collect_nodes()
        for node in self.exec_order:
            if "." in node.key:
                raise ValueError(
                    f"node key {node.key!r} holds a '.', which a torch "
                    "submodule name cannot: name the module without one")
            self.add_module(node.key, node.module)
        self._plan = None
        self._schedule()

    def _schedule(self):
        self._frames = FrameManager(self.exec_order)
        self._scheduler = Scheduler(self.exec_order, self._frames)

    def _collect_nodes(self) -> List[Node]:
        """Every node the outputs reach, in the reference's order (a stack
        walk from the outputs; the seen set breaks the loop cycles)."""
        nodes: List[Node] = []
        seen: Set[int] = set()
        stack = list(self.output_nodes)
        while stack:
            n = stack.pop()
            if id(n) in seen:
                continue
            seen.add(id(n))
            nodes.append(n)
            stack.extend(n.prev)
        return nodes

    def forward(self, input):
        if isinstance(input, (Table, list, tuple)):
            inputs = list(input)
        else:
            inputs = [input]
        if len(inputs) != len(self.input_nodes):
            raise ValueError(
                f"graph expects {len(self.input_nodes)} inputs, "
                f"got {len(inputs)}")
        given = {id(n): v for n, v in zip(self.input_nodes, inputs)}

        def fire(node: Node, values):
            if id(node) in given:
                return given[id(node)]
            args = []
            ports = getattr(node, "_switch_ports", {})
            for p in node.prev:
                v = values.get(id(p), DEAD)
                if isinstance(p.module, SwitchOps):
                    # the consumer reads the port its edge recorded
                    port = ports.get(id(p))
                    if port is not None and v is not DEAD:
                        v = v[port + 1]
                args.append(v)
            if not isinstance(node.module, ControlOps) \
                    and any(a is DEAD for a in args):
                return DEAD  # dead propagation through ordinary ops
            if not args:
                x = Table()
            else:
                x = args[0] if len(args) == 1 else Table(*args)
            return node.module(x)

        values = self._scheduler.run(fire, self.output_nodes)
        outs = [values[id(o)] for o in self.output_nodes]
        return outs[0] if len(outs) == 1 else Table(*outs)

    def __deepcopy__(self, memo):
        """The nodes copied in two passes (back edges point forward in
        `exec_order`), Switch ports re-keyed to the copied Switches, the
        frames and the scheduler rebuilt."""
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        nodes = {id(n): n for n in itertools.chain(
            self.exec_order, self.input_nodes, self.output_nodes)}
        copies = {}
        for key, node in nodes.items():
            c = Node.__new__(Node)
            c.__dict__.update({k: v for k, v in node.__dict__.items()
                               if k not in ("module", "prev",
                                            "_switch_ports")})
            copies[key] = memo[key] = c
        for key, node in nodes.items():
            c = copies[key]
            c.prev = [copies[id(p)] for p in node.prev]
            ports = getattr(node, "_switch_ports", None)
            if ports is not None:
                c._switch_ports = {id(copies[s]): port
                                   for s, port in ports.items()
                                   if s in copies}
        new.__dict__.update(copy.deepcopy(
            {k: v for k, v in self.__dict__.items()
             if k not in ("_plan", "_frames", "_scheduler")}, memo))
        new._plan = None
        for key, node in nodes.items():
            copies[key].module = copy.deepcopy(node.module, memo)
        new._schedule()
        return new


def switch_port(consumer: Node, switch_node: Node, port: int) -> Node:
    """Record which output of `switch_node` `consumer` reads (0 false, 1
    true; TF's 'switch:0' / 'switch:1'); returns `consumer`."""
    if not hasattr(consumer, "_switch_ports"):
        consumer._switch_ports = {}
    consumer._switch_ports[id(switch_node)] = port
    return consumer
