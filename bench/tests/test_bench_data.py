"""The inputs made from the seed."""
import torch

from bench import data, weights
from small_cells import cell


def test_same_seed_same_inputs_other_seed_same_sizes():
    _, _, cfg, traffic = cell("vgg9-k20-fedldf")
    a = data.images(traffic["data"], cfg["model"], 10, 2**31 + 3, "cpu")
    b = data.images(traffic["data"], cfg["model"], 10, 2**31 + 3, "cpu")
    c = data.images(traffic["data"], cfg["model"], 10, 5, "cpu")
    assert torch.equal(a.xs, b.xs) and torch.equal(a.part_idx, b.part_idx)
    assert not torch.equal(a.xs, c.xs)
    assert a.xs.shape == c.xs.shape and torch.equal(a.part_sizes,
                                                    c.part_sizes)


def test_tokens_split_by_domain():
    _, _, cfg, traffic = cell("hymba-ft-seq512")
    ds = data.tokens(traffic["data"], cfg["model"]["vocab_size"], 8, 7, "cpu")
    n = traffic["data"]["num_sequences"]
    assert ds.xs.shape == (n, traffic["data"]["seq_len"])
    assert torch.equal(ds.xs[:, 1:], ds.ys[:, :-1])
    assert int(ds.part_sizes.sum()) == n


def test_the_checked_rounds_train_on_rows_that_all_differ():
    draws = data.Draws(2**31 + 11, [1000] * 50, 50, 20, 32)
    seen = {}
    for t in range(3):
        for c in draws.clients(t).tolist():
            rows = draws.rows(t, c).tolist()
            assert not set(rows) & seen.get(c, set())
            seen.setdefault(c, set()).update(rows)
    rd = draws(0)
    clients = rd.clients(50, 20)
    assert torch.equal(clients, draws.clients(0))
    assert rd.indices(torch.full((20,), 1000), 32).shape == (20, 32)


def test_weights_bit_for_bit_from_the_seed():
    spec_ = [(("a", "w"), (3, 4), ("normal", 0.5)),
             (("a", "b"), (4,), ("const", 0.0)),
             (("c",), (2, 2), ("normal", 2.0))]
    w1 = weights.make(spec_, 2**31 + 1, "cpu")
    w2 = weights.make(spec_, 2**31 + 1, "cpu")
    assert torch.equal(w1["a"]["w"], w2["a"]["w"])
    assert torch.equal(w1["c"], w2["c"]) and not torch.any(w1["a"]["b"])
