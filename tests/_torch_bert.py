"""Shared pieces of the port's BERT import tests: the weight promotion and
the [CLS] head of ``tests/bert_helpers.py``, over either package's API,
so one graph gets the same head in both."""
import numpy as np


def promote(sd, min_size):
    """Every float constant over ``min_size`` elements made trainable."""
    n = 0
    for var in list(sd.variables()):
        dt = var.dtype
        floating = (dt.is_floating_point if hasattr(dt, "is_floating_point")
                    else np.issubdtype(np.dtype(dt), np.floating))
        if (var.var_type.value == "CONSTANT" and var.shape and floating
                and int(np.prod(var.shape)) > min_size):
            var.convert_to_variable()
            n += 1
    return n


def attach_head(mod, upd, sd, gd, hidden_size=32, n_classes=2, lr=5e-3,
                seed=0):
    """A linear head on the [CLS] position (weights drawn from ``seed``,
    so the trunk's gradient is not zero), softmax cross-entropy, Adam."""
    out_name = [n.name for n in gd.node if n.op == "Identity"][-1]
    cls = sd.get_variable(out_name)[:, 0]
    w = sd.var("head_w", init=np.random.default_rng(seed).normal(
        0.0, 0.02, (hidden_size, n_classes)).astype(np.float32))
    b = sd.var("head_b", init=np.zeros((n_classes,), np.float32))
    lab = sd.placeholder("label", (None, n_classes))
    sd.loss.softmax_cross_entropy(lab, cls.mmul(w) + b).rename("loss")
    sd.set_training_config(mod.TrainingConfig(
        updater=upd.Adam(lr),
        data_set_feature_mapping=["input_ids", "attention_mask"],
        data_set_label_mapping=["label"], loss_variables=["loss"]))
    return sd
