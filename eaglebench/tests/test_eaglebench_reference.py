"""The plain reference against the paper's equations on cases small
enough to work by hand."""
import math

import numpy as np
import pytest
import torch

from eaglebench.reference import router as REF


def test_elo_fold_by_hand():
    r = REF.elo_fold([1000.0, 1000.0], [0, 1], [1, 0], [1.0, 0.5], k=32.0)
    # E = 0.5 -> +16; then model 1 draws at 984 against 1016
    e1 = 1 / (1 + 10 ** ((1016 - 984) / 400))
    d = 32 * (0.5 - e1)
    assert r == pytest.approx([1016 - d, 984 + d], abs=1e-12)
    assert np.array_equal(REF.elo_fold([5.0, 7.0], [1], [1], [1.0], k=32.0),
                          [5.0, 7.0])          # a == b changes nothing
    ctl = REF.elo_fold([1000.0, 1000.0], [0, 1], [1, 0], [1.0, 0.5], k=32.0,
                       precision="control")
    assert ctl[0] == 1016.0 and ctl[1] != pytest.approx(r[1], abs=1e-3)


def test_db_rows_follow_first_appearance():
    emb = np.zeros((8, 2))
    emb[7], emb[3] = [3.0, 4.0], [0.0, 2.0]
    db = REF.build_db([7, 3, 7], [0, 1, 2], [1, 2, 0], [1.0, 0.0, 0.5], emb,
                      slots=4)
    assert list(db.prompt) == [7, 3]
    assert db.emb == pytest.approx(np.asarray([[0.6, 0.8], [0.0, 1.0]]))
    assert db.model_a[0, :2].tolist() == [0, 2] and db.valid.sum() == 3
    assert db.outcome[0, 1] == 0.5 and db.model_b[1, 0] == 2
    with pytest.raises(ValueError):
        REF.build_db([1, 1, 1], [0, 0, 0], [1, 1, 1], [1, 1, 1], emb,
                     slots=2)


def _tiny_db():
    emb = np.asarray([[1.0, 0.0], [0.0, 1.0], [0.6, 0.8]])
    return REF.build_db([0, 1, 2], [0, 0, 1], [1, 1, 0], [1.0, 0.5, 1.0],
                        emb, slots=2)


def test_route_replays_the_farthest_first():
    db = _tiny_db()
    q = np.asarray([[1.0, 0.1]])
    g = np.asarray([[1000.0, 1000.0]])
    scores, choice = REF.route(q, db, [3], g, [1.0, 2.0], [2.0], n=2,
                               k=32.0, p=0.5)
    # neighbours: row 0 (0.995), row 2 (0.677); row 2's record (1 beats
    # 0) first, then row 0's (0 beats 1) from 984 / 1016
    e0 = 1 / (1 + 10 ** ((1016 - 984) / 400))
    local = [984 + 32 * (1 - e0), 1016 - 32 * (1 - e0)]
    assert scores[0] == pytest.approx([500 + local[0] / 2,
                                       500 + local[1] / 2], abs=1e-9)
    assert choice[0] == 0
    _, c = REF.route(q, db, [3], g, [2.0, 1.0], [1.5], n=2, k=32.0, p=0.5)
    assert c[0] == 1                              # only model 1 fits
    _, c = REF.route(q, db, [3], g, [2.0, 1.0], [0.5], n=2, k=32.0, p=0.5)
    assert c[0] == 1                              # none fits: the cheapest
    # two live rows: row 2 is dead, row 1 (0.0995) is the far neighbour
    s2, _ = REF.route(q, db, [2], g, [1.0, 2.0], [2.0], n=2, k=32.0, p=0.5)
    assert s2[0] != pytest.approx(scores[0])


def test_choice_gaps():
    s = np.asarray([[10.0, 8.5, 12.0]])
    costs, bud = [1.0, 2.0, 9.0], [2.0]
    assert REF.choice_gaps(s, [0], costs, bud)[0] == 0.0
    assert REF.choice_gaps(s, [1], costs, bud)[0] == 1.5
    assert REF.choice_gaps(s, [2], costs, bud)[0] == math.inf   # over budget
    assert REF.choice_gaps(s, [7], costs, bud)[0] == math.inf   # no model
    assert REF.choice_gaps(s, [0], costs, [0.5])[0] == 0.0      # cheapest


def test_control_rounds_to_tf32():
    x = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -10, -3.0 - 2.0 ** -11])
    assert REF._tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -10, -3.0]
