"""Styled-hint (paraphrase) robustness evaluation (port of
text2loc_tpu/evaluation/styled.py: render_styled_queries,
render_canonical_queries, eval_styled_retrieval, over the port's
Localizer.localize_text).

The paper's paraphrase-robustness story: queries phrased with the
`sentence_style_*` template banks instead of the canonical hint template
(the reference's datapreparation/kitti360pose/utils.py:237-453, imported by
the reference's dataloaders but never wired to anything runnable). Here it
IS runnable: every evaluation pose is re-rendered through sampled
paraphrases (text_styles.py) and pushed through
`Localizer.localize_text`, whose out-of-vocabulary path routes the styled
sentences through the online frozen-LLM encoder (models/t5_encoder.py) —
exactly how a real paraphrased user query would be served. Canonical
queries through the same front door give the baseline; the gap is the
robustness number.

Eval CLI: `--styled_hints` (evaluation/cli.py). With a T5 snapshot
(`--t5_snapshot`) the real tokenizer+encoder runs; without one the
compositional stand-in keeps the mode exercisable in CI.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from text2loc_tpu_torch import text_styles
from text2loc_tpu_torch.evaluation import metrics


def render_styled_queries(data, rng: np.random.Generator,
                          pose_indices: Optional[np.ndarray] = None):
    """One paraphrased description string per evaluation pose."""
    pi = (
        np.arange(data.num_poses)
        if pose_indices is None else np.asarray(pose_indices)
    )
    return [
        text_styles.render_styled_description(
            data.hint_dir[p], data.hint_color[p], data.hint_label[p],
            data.hint_mask[p], rng=rng,
        )
        for p in pi
    ]


def render_canonical_queries(data,
                             pose_indices: Optional[np.ndarray] = None):
    """The canonical-template counterpart (text.render_description)."""
    from text2loc_tpu_torch.text import render_description

    pi = (
        np.arange(data.num_poses)
        if pose_indices is None else np.asarray(pose_indices)
    )
    return [
        render_description(
            data.hint_dir[p], data.hint_color[p], data.hint_label[p],
            data.hint_mask[p],
        )
        for p in pi
    ]


def _recall(result, data, pi, top_k) -> Tuple[Dict, Dict]:
    return metrics.retrieval_accuracies(
        retrieved_cell_idx=np.asarray(result.cell_indices),
        target_cell_idx=data.pose_cell_idx[pi],
        pose_w=data.pose_w[pi, :2],
        cell_centers=data.cell_centers,
        cell_size=float(data.cell_size[0]),
        top_k=top_k,
    )


def eval_styled_retrieval(localizer, data, *, seed: int = 0,
                          top_k: Sequence[int] = (1, 3, 5),
                          pose_indices: Optional[np.ndarray] = None,
                          include_canonical: bool = True) -> Dict:
    """Styled-vs-canonical retrieval through the text front door.

    Returns {"styled": {"recall", "recall_close", "mean_error_m"},
    "canonical": ... (when requested)}; the canonical pass uses the SAME
    localize_text entry (in-vocabulary -> sentence-table fast path), so the
    gap isolates the paraphrasing, not the serving plumbing.
    """
    pi = (
        np.arange(data.num_poses)
        if pose_indices is None else np.asarray(pose_indices)
    )
    top_k = tuple(k for k in top_k if k <= localizer.top_k) or (1,)
    rng = np.random.default_rng(seed)
    out: Dict = {}
    runs = {"styled": render_styled_queries(data, rng, pi)}
    if include_canonical:
        runs["canonical"] = render_canonical_queries(data, pi)
    for name, queries in runs.items():
        result = localizer.localize_text(queries)
        acc, acc_close = _recall(result, data, pi, top_k)
        err = np.linalg.norm(
            np.asarray(result.position_w) - data.pose_w[pi, :2], axis=1
        )
        out[name] = {
            "recall": {int(k): float(v) for k, v in acc.items()},
            "recall_close": {int(k): float(v) for k, v in acc_close.items()},
            "mean_error_m": float(err.mean()),
        }
    if include_canonical:
        out["recall_gap"] = {
            int(k): out["canonical"]["recall"][k] - out["styled"]["recall"][k]
            for k in out["styled"]["recall"]
        }
    return out
