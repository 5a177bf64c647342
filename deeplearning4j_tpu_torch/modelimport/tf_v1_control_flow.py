"""TF V1 (frame-based) control-flow reconstruction for the GraphDef importer:
counterpart of ``deeplearning4j_tpu/modelimport/tf_v1_control_flow.py``
(a copy: it reads NodeDefs only, from the port's ``tf_proto`` or TF's).

Reference: the legacy Enter/Exit/Merge/Switch/NextIteration frame protocol
handled by ``org.nd4j.autodiff.samediff.internal.AbstractSession``'s
dependency tracker (SURVEY.md:314-317 — "control-flow Enter/Exit/Merge/Switch
supported for imported TF graphs"). The reference *interprets* frames at
session run time. Here the frames are statically rewritten at import time
into the functional ``sd.while_loop`` / ``sd.if_cond`` composites:

- a V1 while frame::

      outer --Enter--> Merge <--NextIteration-- body
                         |--> cond --LoopCond--+
                         v                     v
                       Switch(data, loopcond) --:1--> body
                         '--:0--> Exit --> outer

  becomes ``sd.while_loop(cond_builder, body_builder, *enter_inputs)`` with
  loop-invariant ``Enter(is_constant)`` tensors riding as pass-through state.
  A V1 ``tf.cond`` inside the loop body is handled recursively: only Merges
  fed by Enter+NextIteration count as loop vars; Switch/Merge pairs guarded
  by something other than LoopCond stay in the body node set and are
  rewritten by the same cond machinery when the body is replayed.

- a V1 cond: all Merges of one ``tf.cond`` call (connected through shared
  ``Switch`` guards) are grouped into ONE ``sd.if_cond`` with one output per
  Merge — shared branch nodes are traced once, not once per output.

Nested while frames (loop-in-loop) are rejected with a clear error.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

_LOOP_OPS = frozenset({"Enter", "Exit", "Merge", "Switch", "NextIteration",
                       "LoopCond"})


def _ref_node(ref: str) -> str:
    ref = ref[1:] if ref.startswith("^") else ref
    return ref.split(":")[0]


def has_v1_control_flow(nodes) -> bool:
    return any(n.op in ("Enter", "Switch") for n in nodes)


@dataclasses.dataclass
class LoopInfo:
    frame: str
    enters: list            # loop-var Enter nodes (merge order)
    inv_enters: list        # is_constant / invariant Enter nodes
    merges: list            # loop-var Merges only
    switches: list          # aligned with merges (None if var unused)
    exits: list             # aligned with merges (None if output unused)
    next_iters: list        # aligned with merges
    loop_cond: object
    cond_nodes: list        # replayed in cond builder (original order)
    body_nodes: list        # replayed in body builder (original order)
    all_names: set          # every node name consumed by the rewrite


@dataclasses.dataclass
class CondGroup:
    """One V1 ``tf.cond`` call: Merges connected through shared Switches."""
    merges: list
    pred_ref: str
    switches: list           # data-guarding switches (operand order)
    true_refs: list          # aligned with merges
    false_refs: list
    branch_nodes: list       # union, original order — replayed per branch
    skip_names: set


def _ancestors(start_refs, by_name, stop_names, nodes_order):
    """Nodes strictly between stop_names and start_refs, in graph order."""
    seen, stack = set(), [_ref_node(r) for r in start_refs]
    while stack:
        nm = stack.pop()
        if nm in seen or nm in stop_names:
            continue
        seen.add(nm)
        node = by_name.get(nm)
        if node is None:
            continue
        for ref in node.input:
            stack.append(_ref_node(ref))
    return [n for n in nodes_order if n.name in seen]


def _is_loop_merge(m, by_name):
    if len(m.input) != 2:
        return False
    a = by_name.get(_ref_node(m.input[0]))
    b = by_name.get(_ref_node(m.input[1]))
    ops = {a.op if a else None, b.op if b else None}
    return ops == {"Enter", "NextIteration"}


def analyze_loops(nodes) -> List[LoopInfo]:
    by_name = {n.name: n for n in nodes}
    frames: Dict[str, list] = {}
    for n in nodes:
        if n.op == "Enter":
            fr = n.attr["frame_name"].s.decode()
            frames.setdefault(fr, []).append(n)

    # frame membership: forward-propagate from Enters
    member: Dict[str, str] = {}
    for fr, ens in frames.items():
        for e in ens:
            member[e.name] = fr
    changed = True
    while changed:
        changed = False
        for n in nodes:
            if n.name in member or n.op == "Enter":
                continue
            for ref in n.input:
                fr = member.get(_ref_node(ref))
                if fr is not None:
                    src = by_name.get(_ref_node(ref))
                    if src is not None and src.op == "Exit":
                        continue        # Exit outputs live in the parent
                    member[n.name] = fr
                    changed = True
                    break

    # an Enter whose input is itself inside a frame ⇒ loop-in-loop
    for fr, ens in frames.items():
        for e in ens:
            if member.get(_ref_node(e.input[0])) is not None:
                raise ValueError(
                    f"nested V1 while frames are not supported (frame "
                    f"{fr!r}); re-export with TF2 functional control flow")

    loops = []
    for fr, ens in frames.items():
        fnodes = [n for n in nodes if member.get(n.name) == fr]
        fnames = {n.name for n in fnodes}
        loop_conds = [n for n in fnodes if n.op == "LoopCond"]
        if len(loop_conds) != 1:
            raise ValueError(f"malformed V1 frame {fr!r}: "
                             f"{len(loop_conds)} LoopCond nodes")
        loop_cond = loop_conds[0]
        # loop-var Merges only; cond-in-body Merges stay in the body set
        merges = [n for n in fnodes
                  if n.op == "Merge" and _is_loop_merge(n, by_name)]
        if not merges:
            raise ValueError(f"malformed V1 frame {fr!r}: no loop-var "
                             f"Merge nodes")
        # loop-var switches are guarded by LoopCond; cond switches are not
        switch_by_data = {}
        for n in fnodes:
            if n.op == "Switch" \
                    and _ref_node(n.input[1]) == loop_cond.name:
                switch_by_data[_ref_node(n.input[0])] = n
        exits_by_switch = {}
        for n in fnodes:
            if n.op == "Exit":
                exits_by_switch[_ref_node(n.input[0])] = n

        enters_lv, switches, exits, next_iters = [], [], [], []
        for m in merges:
            ent = by_name[_ref_node(m.input[0])]
            ni = by_name[_ref_node(m.input[1])]
            if ent.op == "NextIteration" and ni.op == "Enter":
                ent, ni = ni, ent
            enters_lv.append(ent)
            next_iters.append(ni)
            sw = switch_by_data.get(m.name)
            switches.append(sw)
            exits.append(exits_by_switch.get(sw.name) if sw is not None
                         else None)
        inv_enters = [e for e in ens if e not in enters_lv]

        stop = {n.name for n in enters_lv} | {n.name for n in inv_enters} \
            | {m.name for m in merges} \
            | {s.name for s in switches if s is not None} \
            | {e.name for e in exits if e is not None} \
            | {ni.name for ni in next_iters} | {loop_cond.name}
        cond_set = {n.name for n in _ancestors(
            [loop_cond.input[0]], by_name, stop, fnodes)}
        body_start = [ni.input[0] for ni in next_iters]
        body_set = {n.name for n in _ancestors(
            body_start, by_name, stop, fnodes)}
        cond_nodes = [n for n in fnodes if n.name in cond_set]
        body_nodes = [n for n in fnodes if n.name in body_set]

        all_names = set(fnames)
        for es in exits:
            if es is not None:
                all_names.add(es.name)
        loops.append(LoopInfo(fr, enters_lv, inv_enters, merges, switches,
                              exits, next_iters, loop_cond, cond_nodes,
                              body_nodes, all_names))
    return loops


def _branch_is_true(ref, by_name) -> bool:
    """Does this merge input come from the TRUE branch? Signals, in order:
    a data path to ``Switch:1`` (output_true), else a control edge to the
    ``switch_t`` pivot (an Identity of ``Switch:1``) — the only connection
    a constant-only branch has. Iterative (explicit stack), like every
    other traversal here — deep unrolled branches must not hit the Python
    recursion limit."""
    seen = set()
    stack = [ref]
    while stack:
        r = stack.pop()
        nm = _ref_node(r)
        if nm in seen:
            continue
        seen.add(nm)
        node = by_name.get(nm)
        if node is None:
            continue
        if node.op == "Switch":
            return r.endswith(":1")
        for cr in node.input:
            if cr.startswith("^"):
                piv = by_name.get(_ref_node(cr))
                if piv is not None and piv.op == "Identity" and piv.input:
                    src = by_name.get(_ref_node(piv.input[0]))
                    if src is not None and src.op == "Switch":
                        return piv.input[0].endswith(":1")
        for dr in node.input:
            if not dr.startswith("^"):
                stack.append(dr)
    raise ValueError(f"cannot classify V1 cond branch for merge input "
                     f"{ref!r} (no Switch reachable by data or pivot "
                     f"control edge)")


def analyze_conds(nodes, loop_names: set) -> List[CondGroup]:
    """Group frameless Switch/Merge pairs (V1 tf.cond) into one CondGroup
    per original tf.cond call (Merges connected through shared Switches)."""
    by_name = {n.name: n for n in nodes}
    consumers: Dict[str, set] = {}
    for n in nodes:
        for ref in n.input:
            consumers.setdefault(_ref_node(ref), set()).add(n.name)

    raw = []      # (merge, switches:set, branch:set, true_ref, false_ref)
    for n in nodes:
        if n.op != "Merge" or n.name in loop_names:
            continue
        if len(n.input) != 2:
            raise ValueError(f"V1 cond Merge {n.name!r} with "
                             f"{len(n.input)} inputs unsupported")

        def branch(ref):
            sws, seen, bnodes = set(), set(), set()
            stack = [_ref_node(ref)]
            while stack:
                nm = stack.pop()
                if nm in seen:
                    continue
                seen.add(nm)
                node = by_name[nm]
                if node.op == "Switch":
                    sws.add(nm)
                    continue
                bnodes.add(nm)
                for r in node.input:
                    if not r.startswith("^"):
                        stack.append(_ref_node(r))
            return sws, bnodes

        sws_a, nodes_a = branch(n.input[0])
        sws_b, nodes_b = branch(n.input[1])
        if _branch_is_true(n.input[0], by_name):
            t_ref, f_ref = n.input[0], n.input[1]
        else:
            t_ref, f_ref = n.input[1], n.input[0]
        raw.append((n, sws_a | sws_b, nodes_a | nodes_b, t_ref, f_ref))

    # connected components over shared switches / shared branch nodes —
    # union-find, so a Merge that bridges two earlier components fuses
    # them (first-match-append would split one tf.cond into two groups)
    parent = list(range(len(raw)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(len(raw)):
        for j in range(i):
            if (raw[i][1] & raw[j][1]) or (raw[i][2] & raw[j][2]):
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[ri] = rj
    comp: Dict[int, List[int]] = {}
    for i in range(len(raw)):
        comp.setdefault(find(i), []).append(i)
    groups = list(comp.values())

    out = []
    for g in groups:
        merges = [raw[i][0] for i in g]
        sw_names = sorted(set().union(*(raw[i][1] for i in g)))
        switches = [by_name[s] for s in sw_names]
        if not switches:
            raise ValueError(f"V1 cond Merge(s) "
                             f"{[m.name for m in merges]} have no Switch "
                             f"guards")
        preds = {s.input[1] for s in switches}
        if len(preds) != 1:
            raise ValueError(f"V1 cond group {[m.name for m in merges]}: "
                             f"switches disagree on predicate ({preds})")
        branch_names = set().union(*(raw[i][2] for i in g))
        branch_nodes = [x for x in nodes if x.name in branch_names]
        internal = branch_names | set(sw_names) | {m.name for m in merges}
        skip = {nm for nm in (branch_names | set(sw_names))
                if consumers.get(nm, set()) <= internal}
        skip |= {m.name for m in merges}
        out.append(CondGroup(merges, next(iter(preds)), switches,
                             [raw[i][3] for i in g],
                             [raw[i][4] for i in g],
                             branch_nodes, skip))
    return out
