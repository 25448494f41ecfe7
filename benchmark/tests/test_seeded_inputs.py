"""The traffic generators and the seeded weights: the same seed gives the
same inputs, another seed others; seeds beyond 32 bits work."""

import numpy as np
import torch

from benchmark import seeding

BIG = 2 ** 31 + 12345


def test_sub_seed_is_a_function_of_its_parts():
    assert seeding.sub_seed(BIG, "x_T", 3) == seeding.sub_seed(BIG, "x_T", 3)
    assert seeding.sub_seed(BIG, "x_T", 3) != seeding.sub_seed(BIG, "x_T", 4)
    assert seeding.sub_seed(BIG, "x_T", 3) != seeding.sub_seed(BIG + 1, "x_T", 3)
    assert 0 <= seeding.sub_seed(-7, "prompts", -1) < 2 ** 63


def test_prompts_and_hints_repeat_under_one_seed():
    def draw(seed):
        rng = np.random.default_rng(seeding.sub_seed(seed, "prompts", 0))
        return seeding.prompt_ids(rng, 8, 8, 77), seeding.hint_images(rng, 2, 16)
    (a_ids, a_img), (b_ids, b_img), (c_ids, _) = draw(BIG), draw(BIG), draw(BIG + 1)
    assert np.array_equal(a_ids, b_ids) and np.array_equal(a_img, b_img)
    assert not np.array_equal(a_ids, c_ids)
    assert (a_ids[:, 0] == seeding.SOT).all() and (a_ids[:, -1] == seeding.EOT).all()
    lengths = (a_ids != seeding.EOT).sum(1) + 1
    assert ((lengths >= 8) & (lengths <= 77)).all()
    assert a_img.dtype == np.float32 and 0 <= a_img.min() and a_img.max() < 1


def test_training_batches_repeat_and_every_step_differs():
    args = (4, 16, (8, 77), (2, 2, 4), 1000, "cpu")
    b0, d0 = seeding.train_batch(BIG, 0, *args)
    b0_again, d0_again = seeding.train_batch(BIG, 0, *args)
    b1, _ = seeding.train_batch(BIG, 1, *args)
    for k in b0:
        assert torch.equal(b0[k], b0_again[k])
    for k in d0:
        assert torch.equal(d0[k], d0_again[k])
    assert not torch.equal(b0["jpg"], b1["jpg"])
    assert b0["jpg"].min() >= -1 and b0["hint"].min() >= 0 and b0["hint"].max() <= 1
    assert d0["t"].min() >= 0 and d0["t"].max() < 1000


def test_seeded_weights_repeat_and_follow_the_leaf_rules():
    shapes = {"a": {"blk.proj.weight": (64, 256), "blk.proj.bias": (64,),
                    "blk.norm.weight": (64,), "site.lora_down": (1, 256, 8),
                    "zero_0.weight": (1, 32, 32, 1, 1)}}
    w1 = seeding.seeded_weights(shapes, BIG, "cpu", {"a": torch.float32})
    w2 = seeding.seeded_weights(shapes, BIG, "cpu", {"a": torch.float32})
    w3 = seeding.seeded_weights(shapes, BIG + 1, "cpu", {"a": torch.float32})
    for k in shapes["a"]:
        assert torch.equal(w1["a"][k], w2["a"][k])
        assert not torch.equal(w1["a"][k], w3["a"][k])
    assert abs(w1["a"]["blk.proj.weight"].std().item() - 256 ** -0.5) < 0.01
    assert abs(w1["a"]["blk.norm.weight"].mean().item() - 1.0) < 0.05
    assert abs(w1["a"]["zero_0.weight"].std().item() - 32 ** -0.5) < 0.02
