"""Shared pipeline stage planning: balancing + dataflow validation.

One source of truth for BOTH the runtime planner (FFModel._plan_pipeline
→ set_pipeline execution) and the stage-assignment search
(simulator/pipeline_search.py) — if the two disagreed, the search would
cost plans the runtime cannot run (or balance them differently than it
executes them).
"""

from __future__ import annotations

from typing import Dict, List, Sequence


def balanced_stages(ops: Sequence, num_stages: int) -> List[List]:
    """Contiguous partition of ``ops`` into ≤ ``num_stages`` groups with
    roughly equal cumulative per-op FLOPs (the reference balances by
    hand; nmt.cc splits encoder/decoder)."""
    S = min(num_stages, len(ops))
    costs = [max(op.flops_per_sample(), 1.0) for op in ops]
    total = sum(costs)
    stages, acc, cur = [], 0.0, []
    for idx, (op, c) in enumerate(zip(ops, costs)):
        cur.append(op)
        acc += c
        ops_left = len(ops) - idx - 1
        stages_left = S - len(stages) - 1
        if len(stages) < S - 1 and (
                acc >= total * (len(stages) + 1) / S
                or ops_left <= stages_left):
            stages.append(cur)
            cur = []
    if cur:
        stages.append(cur)
    return [g for g in stages if g]


def plan_boundaries(stages: List[List], tail: Sequence, const_guids,
                    input_tensors: Sequence):
    """Dataflow plan for the GPipe ring over an ARBITRARY graph.

    Each stage is any subgraph (branches, multiple inputs, skip
    connections welcome — the reference pipelines arbitrary per-op GPU
    placements, nmt/nmt.cc:269-308).  The hop from stage ``si`` to
    ``si+1`` carries ``boundaries[si]``: every tensor already available
    after stage ``si`` (graph input or produced at a stage <= si) that a
    later stage still needs — k tensors per hop, packed into one flat
    ring payload by the executor.  A tensor produced at stage 1 and
    consumed at stage 3 simply rides two hops.

    Returns ``(seg_ins, boundaries)`` where ``seg_ins`` is the ordered
    list of graph inputs the segment consumes (stage 0's inbound
    bundle).  Raises ``ValueError`` when a non-final tensor escapes to
    the tail, or a stage consumes a tensor no earlier stage produced
    (a non-topological partition).
    """
    S = len(stages)
    input_guids = {t.guid for t in input_tensors}
    stage_of: Dict[int, int] = {}
    for si, g in enumerate(stages):
        for op in g:
            for t in op.outputs:
                stage_of[t.guid] = si

    # consumption map: guid -> last stage that reads it
    last_use: Dict[int, int] = {}
    seen_inputs: Dict[int, object] = {}
    for si, g in enumerate(stages):
        for op in g:
            for t in op.inputs:
                if t.guid in const_guids:
                    continue
                if t.guid in input_guids:
                    seen_inputs.setdefault(t.guid, t)
                elif t.guid not in stage_of:
                    raise ValueError(
                        f"pipeline: op {op.name} (stage {si}) consumes "
                        f"tensor {t.guid} produced by no stage and not a "
                        f"graph input — stages must follow a topological "
                        f"order of the graph")
                elif stage_of[t.guid] > si:
                    raise ValueError(
                        f"pipeline: op {op.name} (stage {si}) consumes a "
                        f"tensor from LATER stage {stage_of[t.guid]} — "
                        f"stages must follow a topological order")
                last_use[t.guid] = max(last_use.get(t.guid, -1), si)

    seg_ins = sorted(seen_inputs.values(), key=lambda t: t.guid)
    boundaries: List[List] = []
    all_tensors = {t.guid: t for g in stages for op in g for t in op.outputs}
    all_tensors.update(seen_inputs)
    if S > 0 and not seg_ins:
        raise ValueError(
            "pipeline: stage 0 consumes no graph input (constants only) "
            "— the ring would have an empty feed bundle; merge the "
            "degenerate stage into its successor")
    for si in range(S - 1):
        hop = [t for guid, t in sorted(all_tensors.items())
               if last_use.get(guid, -1) > si
               and (guid in seen_inputs or stage_of.get(guid, S) <= si)]
        if not hop:
            # the executor packs each hop with _bundle_pack, which has
            # no representation for an empty payload — fail with the
            # plan-level diagnosis instead of an IndexError deep in jit
            raise ValueError(
                f"pipeline: hop {si}->{si + 1} carries no tensors (later "
                f"stages consume only constants) — degenerate partition; "
                f"merge stage {si + 1} into stage {si} or use fewer "
                f"stages")
        boundaries.append(hop)

    final_out = stages[-1][-1].output
    inner = set(stage_of.keys()) - {final_out.guid}
    for op in tail:
        for t in op.inputs:
            if t.guid in inner:
                raise ValueError("pipeline: tensor escapes the segment")
    return seg_ins, boundaries


