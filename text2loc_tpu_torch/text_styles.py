"""Paraphrase sentence-style banks and styled hint rendering (the port's own
copy of text2loc_tpu/text_styles.py: SENTENCE_STYLES, num_styles,
render_styled_hint, render_styled_description; held equal to it by
tests/test_torch_port_styled.py).

The reference ships five banks of template paraphrases for the hint
sentences — `sentence_style_{t,n,s,e,w}` in its
datapreparation/kitti360pose/utils.py:237-453 — the repo's
only artifact of the paper's paraphrase-robustness evaluation. They are
imported by the reference's dataloaders (dataloading/kitti360pose/poses.py:28,
eval.py:23) but never invoked at runtime; here they power a working
styled-hint evaluation mode (evaluation/styled.py, eval CLI
`--styled_hints`): each hint triple is rendered through a sampled paraphrase
instead of the canonical template, which takes the query OUTSIDE the closed
hint vocabulary and through the online frozen-LLM encoder
(`Localizer.localize_text` OOV path).

The banks are protocol STRING DATA (like the scene/class/color tables in
constants.py), reproduced with two hygiene fixes, both documented:

* the reference's `sentence_style_t` accidentally merges two templates via
  implicit string concatenation (a missing comma after "...base for the
  pose." at utils.py:258) — they are kept as two separate variants here;
* exact duplicate entries inside a bank (the reference repeats e.g.
  "{Object} serves as the surface beneath the pose.") are deduplicated, so
  sampling is uniform over DISTINCT paraphrases.

Placeholders: `{object}` receives the canonical object phrase
"a <color> <label>" (mid-sentence), `{Object}` the capitalized
"A <color> <label>" (sentence-initial) — matching the reference templates'
casing convention.

The reference defines banks only for on-top and the four cardinal
directions; the diagonal directions our DIRECTIONS table also carries
(north-east, ...) have no reference paraphrases and fall back to the
canonical HINT_TEMPLATE (documented fallback, exercised in tests).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from text2loc_tpu_torch import constants as C

# reference utils.py:237-263 (sentence_style_t)
_STYLE_ON_TOP = (
    "The pose is over {object}.",
    "The pose is above {object}.",
    "The pose lies over {object}.",
    "The pose lies above {object}.",
    "The pose is positioned directly above {object}.",
    "The pose is positioned directly over {object}.",
    "The pose is resting atop {object}.",
    "The pose is situated right over {object}.",
    "The pose is situated right above {object}.",
    "The pose is perched on top of {object}.",
    "The pose is firmly placed on top of {object}.",
    "The pose is positioned vertically over {object}.",
    "The pose is firmly resting on top of {object}.",
    "The pose is placed right over {object}.",
    "The pose is placed right above {object}.",
    "{Object} is the ground on which the pose is placed.",
    "{Object} serves as the surface beneath the pose.",
    "{Object} serves as the base for the pose.",
    "{Object} acts as the foundation for the pose.",
)

# reference utils.py:265-310 (sentence_style_n)
_STYLE_NORTH = (
    "The pose is located to the north of {object}.",
    "{Object} is positioned south of the pose.",
    "When facing south at the pose, we can find {object}.",
    "The pose lies at the northern side relative to {object}.",
    "{Object} is situated in the southern direction compared to the pose.",
    "The pose can be reached by traveling north from {object}.",
    "The north side of the map corresponds to the pose's location, "
    "while {object} is in the south.",
    "{Object} is in the southern region relative to the pose.",
    "In terms of orientation, the pose faces north from {object}.",
    "To the upper side of {object} on a map, you'll discover the pose.",
    "{Object}'s placement is southward from the pose.",
    "The pose's placement is higher on the map, north of {object}.",
    "The spatial arrangement is such that the pose is positioned to the "
    "north compared to {object}.",
    "The pose is found northward from {object}.",
    "Traveling north from {object} leads you to the pose.",
    "The pose is in the direction of the north with respect to {object}.",
    "In terms of cardinal directions, the pose is to the north of {object}.",
    "If you head south from the pose, you'll see {object}.",
    "If you head north from {object}, you'll see the pose.",
    "{Object} is located in the southern direction from the pose.",
    "On a map, the pose is northward from the location of {object}.",
    "In relation to {object}, the pose is positioned in the north.",
    "In relation to the pose, {object} is positioned in the south.",
    "The pose is positioned to the top of {object} on a geographic scale.",
    "North of {object} lies the pose.",
    "South of the pose lies {object}.",
    "{Object}'s location is to the south of the pose.",
    "The pose is the northern neighbor of {object}.",
    "The pose is geographically positioned higher than {object}.",
    "{Object} is situated in the southern part in comparison to the pose.",
    "In terms of directions, the pose is in the north of {object}.",
    "The pose can be located by moving north from {object}.",
    "In the northern direction lies the pose, relative to {object}.",
    "{Object} is positioned southward from the pose.",
    "When facing southward at the pose, you encounter {object}.",
    "{Object} is situated in the southern region compared to the pose.",
    "In the context of directions, the pose is in the north relative to "
    "{object}.",
    "The pose can be reached by heading north from {object}'s position.",
    "The pose's geographic coordinates are oriented to the north of "
    "{object}.",
    "To the north of {object}, you'll find the pose.",
    "The map's upper part corresponds to the pose's position, while "
    "{object} is in the lower part.",
    "{Object} is situated to the south of the pose's point of reference.",
)

# reference utils.py:312-358 (sentence_style_s)
_STYLE_SOUTH = (
    "The pose is located to the south of {object}.",
    "{Object} is positioned north of the pose.",
    "When facing north at the pose, we can find {object}.",
    "The pose lies at the southern side relative to {object}.",
    "{Object} is situated in the northern direction compared to the pose.",
    "The pose can be reached by traveling south from {object}.",
    "The south side of the map corresponds to the pose's location, "
    "while {object} is in the north.",
    "{Object} is in the northern region relative to the pose.",
    "In terms of orientation, the pose faces south from {object}.",
    "To the lower side of {object} on a map, you'll discover the pose.",
    "{Object}'s placement is northward from the pose.",
    "The pose's placement is lower on the map, south of {object}.",
    "The spatial arrangement is such that the pose is positioned to the "
    "south compared to {object}.",
    "The pose is found southward from {object}.",
    "Traveling south from {object} leads you to the pose.",
    "The pose is in the direction of the south with respect to {object}.",
    "In terms of cardinal directions, the pose is to the south of {object}.",
    "If you head north from the pose, you'll see {object}.",
    "If you head south from {object}, you'll see the pose.",
    "{Object} is located in the northern direction from the pose.",
    "On a map, the pose is southward from the location of {object}.",
    "In relation to {object}, the pose is positioned in the south.",
    "In relation to the pose, {object} is positioned in the north.",
    "The pose is positioned to the bottom of {object} on a geographic "
    "scale.",
    "South of {object} lies the pose.",
    "North of the pose lies {object}.",
    "{Object}'s location is to the north of the pose.",
    "The pose is the southern neighbor of {object}.",
    "The pose is geographically positioned lower than {object}.",
    "{Object} is situated in the northern part in comparison to the pose.",
    "In terms of directions, the pose is in the south of {object}.",
    "The pose can be located by moving south from {object}.",
    "In the southern direction lies the pose, relative to {object}.",
    "{Object} is positioned northward from the pose.",
    # kept verbatim from the reference, including its copy-paste oddity
    # ("higher ... south" — utils.py:348): paraphrase robustness is about
    # surface variety, not geometric self-consistency of every variant.
    "The pose's placement is higher on the map, south of {object}.",
    "When facing northward at the pose, you encounter {object}.",
    "{Object} is situated in the northern region compared to the pose.",
    "In the context of directions, the pose is in the south relative to "
    "{object}.",
    "The pose can be reached by heading south from {object}'s position.",
    "The pose's geographic coordinates are oriented to the south of "
    "{object}.",
    "To the south of {object}, you'll find the pose.",
    "The map's upper part corresponds to the pose's position, while "
    "{object} is in the lower part.",
    "{Object} is situated to the north of the pose's point of reference.",
)

# reference utils.py:360-406 (sentence_style_e)
_STYLE_EAST = (
    "The pose is located to the east of {object}.",
    "{Object} is positioned west of the pose.",
    "When facing west at the pose, we can find {object}.",
    "The pose lies at the eastern side relative to {object}.",
    "{Object} is situated in the western direction compared to the pose.",
    "The pose can be reached by traveling east from {object}.",
    "The east side of the map corresponds to the pose's location, "
    "while {object} is in the west.",
    "{Object} is in the western region relative to the pose.",
    "In terms of orientation, the pose faces east from {object}.",
    "To the right side of {object} on a map, you'll discover the pose.",
    "{Object}'s placement is westward from the pose.",
    "The pose's placement is further right on the map, east of {object}.",
    "The spatial arrangement is such that the pose is positioned to the "
    "east compared to {object}.",
    "The pose is found eastward from {object}.",
    "Traveling east from {object} leads you to the pose.",
    "The pose is in the direction of the east with respect to {object}.",
    "In terms of cardinal directions, the pose is to the east of {object}.",
    "If you head west from the pose, you'll see {object}.",
    "If you head east from {object}, you'll see the pose.",
    "{Object} is located in the western direction from the pose.",
    "On a map, the pose is eastward from the location of {object}.",
    "In relation to {object}, the pose is positioned in the east.",
    "In relation to the pose, {object} is positioned in the west.",
    "The pose is positioned to the right of {object} on a geographic "
    "scale.",
    "East of {object} lies the pose.",
    "West of the pose lies {object}.",
    "{Object}'s location is to the west of the pose.",
    "The pose is the eastern neighbor of {object}.",
    "The pose is geographically positioned further right than {object}.",
    "{Object} is situated in the western part in comparison to the pose.",
    "In terms of directions, the pose is in the east of {object}.",
    "The pose can be located by moving east from {object}.",
    "In the eastern direction lies the pose, relative to {object}.",
    "{Object} is positioned westward from the pose.",
    "The pose's placement is higher on the map, east of {object}.",
    "When facing westward at the pose, you encounter {object}.",
    "{Object} is situated in the western region compared to the pose.",
    "In the context of directions, the pose is in the east relative to "
    "{object}.",
    "The pose can be reached by heading east from {object}'s position.",
    "The pose's geographic coordinates are oriented to the east of "
    "{object}.",
    "To the east of {object}, you'll find the pose.",
    "The map's upper part corresponds to the pose's position, while "
    "{object} is in the lower part.",
    "{Object} is situated to the west of the pose's point of reference.",
)

# reference utils.py:408-453 (sentence_style_w)
_STYLE_WEST = (
    "The pose is located to the west of {object}.",
    "{Object} is positioned east of the pose.",
    "When facing east at the pose, we can find {object}.",
    "The pose lies at the western side relative to {object}.",
    "{Object} is situated in the eastern direction compared to the pose.",
    "The pose can be reached by traveling west from {object}.",
    "The west side of the map corresponds to the pose's location, "
    "while {object} is in the east.",
    "{Object} is in the eastern region relative to the pose.",
    "In terms of orientation, the pose faces west from {object}.",
    "To the further left side of {object} on a map, you'll discover the "
    "pose.",
    "{Object}'s placement is eastward from the pose.",
    "The pose's placement is further left on the map, west of {object}.",
    "The spatial arrangement is such that the pose is positioned to the "
    "west compared to {object}.",
    "The pose is found westward from {object}.",
    "Traveling west from {object} leads you to the pose.",
    "The pose is in the direction of the west with respect to {object}.",
    "In terms of cardinal directions, the pose is to the west of {object}.",
    "If you head east from the pose, you'll see {object}.",
    "If you head west from {object}, you'll see the pose.",
    "{Object} is located in the eastern direction from the pose.",
    "On a map, the pose is westward from the location of {object}.",
    "In relation to {object}, the pose is positioned in the west.",
    "In relation to the pose, {object} is positioned in the east.",
    "The pose is positioned to the left of {object} on a geographic scale.",
    "West of {object} lies the pose.",
    "East of the pose lies {object}.",
    "{Object}'s location is to the east of the pose.",
    "The pose is the western neighbor of {object}.",
    "The pose is geographically positioned further left than {object}.",
    "{Object} is situated in the eastern part in comparison to the pose.",
    "In terms of directions, the pose is in the west of {object}.",
    "The pose can be located by moving west from {object}.",
    "In the western direction lies the pose, relative to {object}.",
    "{Object} is positioned eastward from the pose.",
    "The pose's placement is higher on the map, west of {object}.",
    "When facing eastward at the pose, you encounter {object}.",
    "{Object} is situated in the eastern region compared to the pose.",
    "In the context of directions, the pose is in the west relative to "
    "{object}.",
    "The pose can be reached by heading west from {object}'s position.",
    "The pose's geographic coordinates are oriented to the west of "
    "{object}.",
    "To the west of {object}, you'll find the pose.",
    "The map's upper part corresponds to the pose's position, while "
    "{object} is in the lower part.",
    "{Object} is situated to the east of the pose's point of reference.",
)

SENTENCE_STYLES: Dict[str, Tuple[str, ...]] = {
    "on-top": _STYLE_ON_TOP,
    "north": _STYLE_NORTH,
    "south": _STYLE_SOUTH,
    "east": _STYLE_EAST,
    "west": _STYLE_WEST,
}


def num_styles(direction: str) -> int:
    """Paraphrase count for a direction word (0 = canonical-only)."""
    return len(SENTENCE_STYLES.get(direction, ()))


def render_styled_hint(direction_idx: int, color_idx: int, label_idx: int,
                       rng: np.random.Generator,
                       style_idx: int | None = None) -> str:
    """One hint triple through a sampled (or chosen) paraphrase template.

    Directions without a reference bank (the diagonals) render canonically.
    """
    direction = C.DIRECTIONS[int(direction_idx)]
    bank = SENTENCE_STYLES.get(direction)
    if not bank:
        return C.render_hint(direction_idx, color_idx, label_idx)
    i = int(rng.integers(len(bank))) if style_idx is None else int(style_idx)
    obj = f"a {C.COLOR_NAMES[int(color_idx)]} {C.INDEX_TO_CLASS[int(label_idx)]}"
    return bank[i % len(bank)].format(object=obj, Object=obj.capitalize())


def render_styled_description(hint_dir, hint_color, hint_label,
                              sentence_mask=None, *,
                              rng: np.random.Generator) -> str:
    """A pose's full description with every hint independently paraphrased
    (the canonical-template counterpart is text.render_description)."""
    hint_dir = np.asarray(hint_dir)
    parts = []
    for s in range(len(hint_dir)):
        if sentence_mask is not None and not sentence_mask[s]:
            continue
        parts.append(
            render_styled_hint(hint_dir[s], hint_color[s], hint_label[s], rng)
        )
    return " ".join(parts)
