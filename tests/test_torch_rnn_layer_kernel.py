"""K11L's work split emulated on the CPU, and the routes to it.

K11Lf / K11Lb (``csrc/rnn_cell.cu``) run a whole LSTM layer over T steps
in one launch on the card, which this machine does not have. What they
decide besides the cell's arithmetic is emulated here, step for step, at
the shapes of ``rnn_cell.layer_geometry``: the row blocks a cluster owns
(the last one ragged), each CTA's slice of hidden units with the four gate
columns it owns (the last CTAs owning fewer units or none), the resident
RW slice, the product as the kernel splits it (a warp's 32 columns, the k
shares it sums one FMA at a time, the shares summed in share order), the
h exchange into every CTA's double-buffered copy at each step, and the
backward's dz gather and dh = dh_pass + dz·RWᵀ for the CTA's units. The
emulation is held against the plain layer (``layer_fwd_reference`` /
``layer_bwd_reference``) and, inside ``LSTMLayer``, against ``jax.vjp`` of
the reference's ``_RnnBase.run``, for LSTM and GravesLSTM, masked (a
trailing cut, an interior gap, an all-zero row) and not, for every K11
activation. Tolerances as PERF.md's recurrent rows: atol 1e-5 (f32 sums in
another order), gradients relative L2 ≤ 1e-5.

Then the routes: H 256 and 200 (R1, R2) take K11L in clusters of 8, wider
layers clusters of 16 up to ``MAX_LAYER_HIDDEN``, past it the per-step K11,
and an activation K11 lacks the plain step; the CPU wrappers take the
plain versions and count nothing; both kernel routes give the same bits
on the CPU; ``rnnTimeStep`` is a T = 1 call of the layer Function.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu_torch.kernels import rnn_cell as rc
from deeplearning4j_tpu_torch.nn.conf import layers as TL

N, T, C, H = 3, 7, 5, 6
ATOL, GRAD_RTOL = 1e-5, 1e-5
ACTS = ["tanh", "identity", "relu", "sigmoid", "hardtanh", "softsign"]
#: (cluster, rows a cluster): the card's shape at N 32 (at H 6 one unit a
#: CTA, two CTAs idle); two CTAs of 3 units over two row blocks, the
#: second ragged; four CTAs of 2 units, the last with none, a row a block
GEOMETRIES = {"card": (8, 4), "two": (2, 2), "four": (4, 1)}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-12))


def _mask():
    m = np.ones((N, T), np.float32)
    m[0, 4:] = 0
    m[1, 2:4] = 0
    m[2, :] = 0
    return m


# ------------------------------------------------------------- emulation
def _product(vec, mat, g):
    """part (ks, R, oc): each share's sum over its k of vec[r, k] *
    mat[k, oc], one multiply-add at a time in increasing k (the kernel's
    ``layer_product``; a warp's lanes past oc compute nothing kept)."""
    rows = vec.shape[0]
    part = torch.zeros((g["ks"], rows, g["oc"]), dtype=vec.dtype)
    for s in range(g["ks"]):
        acc = torch.zeros((rows, g["oc"]), dtype=vec.dtype)
        for k in range(s * g["chunk"], min(g["kp"], (s + 1) * g["chunk"])):
            acc = acc + vec[:, k, None] * mat[k]
        part[s] = acc
    return part


def _share_sum(part):
    out = part[0]
    for s in range(1, part.shape[0]):
        out = out + part[s]
    return out


def _slices(hd, cluster):
    """Each CTA's (j0, units)."""
    u = -(-hd // cluster)
    return [(q * u, max(0, min(u, hd - q * u))) for q in range(cluster)]


def _gate_cols(hd, j0, units):
    return [q * hd + j0 + u for q in range(4) for u in range(units)]


def emulate_fwd(xw, rw, b, peep, m, h0, c0, act, cluster, rows):
    """K11Lf's outputs (ys, hs, cs, gates) computed as its CTAs compute
    them."""
    t_len, n, _ = xw.shape
    hd = rw.shape[0]
    g = rc.layer_geometry("fwd", hd, cluster, rows)
    hs = xw.new_zeros((t_len, n, hd))
    cs, gates = torch.zeros_like(hs), torch.zeros_like(xw)
    ys = None if m is None else torch.zeros_like(hs)
    for row0 in range(0, n, rows):
        live = list(range(row0, min(n, row0 + rows)))
        ctas = []
        for j0, units in _slices(hd, cluster):
            mat = xw.new_zeros((g["kp"], g["oc"]))
            cols = _gate_cols(hd, j0, units)
            for q in range(4):
                mat[:hd, q * g["units"]:q * g["units"] + units] = \
                    rw[:, q * hd + j0:q * hd + j0 + units]
            vec = xw.new_zeros((2, rows, g["kp"]))
            vec[0, :len(live), :hd] = h0[live]
            ctas.append({"j0": j0, "units": units, "cols": cols, "mat": mat,
                         "vec": vec, "c": c0[live][:, j0:j0 + units]})
        for t in range(t_len):
            pushes = []
            for cta in ctas:
                part = _product(cta["vec"][t % 2], cta["mat"], g)
                j0, units = cta["j0"], cta["units"]
                if not units:
                    continue
                s = _share_sum(part)[:len(live)]
                own = [q * g["units"] + u for q in range(4)
                       for u in range(units)]
                z = (xw[t][live][:, cta["cols"]] + s[:, own]
                     + b[cta["cols"]])
                h_prev = cta["vec"][t % 2][:len(live), j0:j0 + units]
                y, h, c, gt = rc.cell_fwd_reference(
                    z, None, cta["c"], h_prev,
                    None if peep is None else peep[:, j0:j0 + units],
                    None if m is None else m[t][live], act)
                cta["c"] = c
                sl = (t, slice(row0, row0 + len(live)), slice(j0, j0 + units))
                hs[sl], cs[sl] = h, c
                gates[t, row0:row0 + len(live), cta["cols"]] = gt
                if ys is not None:
                    ys[sl] = y
                pushes.append((j0, units, h))
            # every CTA writes its slice into every CTA's next buffer
            for cta in ctas:
                for j0, units, h in pushes:
                    cta["vec"][(t + 1) % 2][:len(live), j0:j0 + units] = h
    return ys, hs, cs, gates


def emulate_bwd(dy, dh, dc, gates, cs, c0, rw, peep, m, act, cluster,
                rows):
    """K11Lb's outputs (dz, dh0, dc0, dpeep) computed as its CTAs compute
    them."""
    t_len, n, _ = gates.shape
    hd = rw.shape[0]
    g = rc.layer_geometry("bwd", hd, cluster, rows)
    dz = torch.zeros_like(gates)
    dh0, dc0 = torch.zeros_like(dh), torch.zeros_like(dc)
    dpeep = None if peep is None else gates.new_zeros((3, n, hd))
    for row0 in range(0, n, rows):
        live = list(range(row0, min(n, row0 + rows)))
        ctas = []
        for j0, units in _slices(hd, cluster):
            mat = gates.new_zeros((g["kp"], g["oc"]))
            mat[:4 * hd, :units] = rw[j0:j0 + units].t()
            ctas.append({"j0": j0, "units": units,
                         "cols": _gate_cols(hd, j0, units), "mat": mat,
                         "vec": gates.new_zeros((2, rows, g["kp"])),
                         "dh": dh[live][:, j0:j0 + units],
                         "dc": dc[live][:, j0:j0 + units],
                         "dp": gates.new_zeros((3, len(live), units))})
        for s in range(t_len):
            t = t_len - 1 - s
            pushes, passes = [], {}
            for cta in ctas:
                j0, units = cta["j0"], cta["units"]
                if not units:
                    continue
                own = slice(j0, j0 + units)
                cp = cs[t - 1] if t > 0 else c0
                got, cta["dc"], dh_pass, dp = rc.cell_bwd_reference(
                    None if dy is None else dy[t][live][:, own], cta["dh"],
                    cta["dc"], gates[t][live][:, cta["cols"]],
                    cs[t][live][:, own], cp[live][:, own],
                    None if peep is None else peep[:, own],
                    None if m is None else m[t][live], act)
                if dp is not None:
                    cta["dp"] = cta["dp"] + dp
                dz[t, row0:row0 + len(live), cta["cols"]] = got
                passes[j0] = dh_pass
                pushes.append((cta["cols"], got))
            for cta in ctas:
                for cols, got in pushes:
                    cta["vec"][s % 2][:len(live), cols] = got
            for cta in ctas:
                part = _product(cta["vec"][s % 2], cta["mat"], g)
                if cta["units"]:
                    sm = _share_sum(part)[:len(live), :cta["units"]]
                    p = passes[cta["j0"]]
                    cta["dh"] = sm if p is None else p + sm
        for cta in ctas:
            own = slice(cta["j0"], cta["j0"] + cta["units"])
            dh0[row0:row0 + len(live), own] = cta["dh"]
            dc0[row0:row0 + len(live), own] = cta["dc"]
            if dpeep is not None:
                dpeep[:, row0:row0 + len(live), own] = cta["dp"]
    return dz, dh0, dc0, dpeep


# ----------------------------------------------------------------- tests
def _operands(peep, masked, seed):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g)
    ops = {"xw": rnd(T, N, 4 * H), "rw": rnd(H, 4 * H) * 0.5,
           "b": rnd(4 * H), "peep": rnd(3, H) * 0.5 if peep else None,
           "m": torch.tensor(_mask()).t().contiguous() if masked else None,
           "h0": rnd(N, H), "c0": rnd(N, H)}
    return ops, rnd(T, N, H), rnd(N, H), rnd(N, H)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("peep", [False, True], ids=["LSTM", "GravesLSTM"])
@pytest.mark.parametrize("act", ACTS)
def test_emulated_split_matches_the_plain_layer(act, peep, masked,
                                                geometry):
    cluster, rows = GEOMETRIES[geometry]
    code = rc.ACTIVATIONS[act]
    ops, dy, dh, dc = _operands(peep, masked, 11 + code)
    want = rc.layer_fwd_reference(**ops, act=code)
    got = emulate_fwd(**ops, act=code, cluster=cluster, rows=rows)
    assert (got[0] is None) == (want[0] is None) == (not masked)
    for a, b in zip(got, want):
        if b is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=ATOL)
    _, _, cs, gates = want
    args = (dy, dh, dc, gates, cs, ops["c0"], ops["rw"], ops["peep"],
            ops["m"], code)
    want_b = rc.layer_bwd_reference(*args)
    got_b = emulate_bwd(*args, cluster=cluster, rows=rows)
    assert (got_b[3] is None) == (not peep)
    for a, b in zip(got_b, want_b):
        if b is not None:
            assert _rel_l2(a.numpy(), b.numpy()) <= GRAD_RTOL


def _layer(ns, peep, act):
    layer = (ns.GravesLSTM if peep else ns.LSTM)(n_in=C, n_out=H,
                                                 activation=act)
    layer.apply_global_defaults({})
    return layer


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("peep", [False, True], ids=["LSTM", "GravesLSTM"])
@pytest.mark.parametrize("act", ACTS)
def test_emulated_layer_matches_reference_vjp(monkeypatch, act, peep,
                                              masked):
    """LSTMLayer on the "k11_layer" route with the emulated kernels in
    place of K11Lf / K11Lb (two CTAs, two row blocks) against ``jax.vjp``
    of the reference ``run``: outputs, carries, every gradient."""
    cluster, rows = GEOMETRIES["two"]
    calls = []
    monkeypatch.setattr(rc, "lstm_layer_fwd", lambda *a: calls.append(
        "fwd") or emulate_fwd(*a, cluster=cluster, rows=rows))
    monkeypatch.setattr(rc, "lstm_layer_bwd", lambda *a: calls.append(
        "bwd") or emulate_bwd(*a, cluster=cluster, rows=rows))
    j, t = _layer(JL, peep, act), _layer(TL, peep, act)
    assert t.cell_route() == "k11_layer"
    rng = np.random.default_rng(40 + rc.ACTIVATIONS[act])
    p = {k: (rng.standard_normal(s) * 0.7).astype(np.float32)
         for k, s in j.param_shapes().items()}
    x = rng.standard_normal((N, T, C)).astype(np.float32)
    c0 = tuple(rng.standard_normal((N, H)).astype(np.float32)
               for _ in range(2))
    mask = _mask() if masked else None
    m_j = None if mask is None else jnp.asarray(mask)
    (jo, jc), vjp = jax.vjp(
        lambda pp, xx, cc: j.run(pp, xx, cc, mask=m_j),
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        tuple(map(jnp.asarray, c0)))
    gy = rng.standard_normal(jo.shape).astype(np.float32)
    gc = tuple(rng.standard_normal((N, H)).astype(np.float32)
               for _ in range(2))
    jp, jx, jc0 = vjp((jnp.asarray(gy), tuple(map(jnp.asarray, gc))))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    tc0 = tuple(torch.tensor(c, requires_grad=True) for c in c0)
    to, tc = t.run(tp, tx, tc0,
                   mask=None if mask is None else torch.tensor(mask))
    ((to * torch.tensor(gy)).sum()
     + sum((a * torch.tensor(b)).sum() for a, b in zip(tc, gc))).backward()
    assert calls == ["fwd", "bwd"]
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               atol=ATOL)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=ATOL)
    for k in jp:
        assert _rel_l2(tp[k].grad.numpy(), jp[k]) <= GRAD_RTOL, k
    assert _rel_l2(tx.grad.numpy(), jx) <= GRAD_RTOL
    for a, b in zip(tc0, jc0):
        assert _rel_l2(a.grad.numpy(), b) <= GRAD_RTOL


@pytest.mark.parametrize("hd,route,cluster", [
    (256, "k11_layer", 8), (200, "k11_layer", 8), (400, "k11_layer", 16),
    (rc.MAX_LAYER_HIDDEN, "k11_layer", 16),
    (rc.MAX_LAYER_HIDDEN + 1, "k11", None), (1024, "k11", None)])
def test_route_by_width(hd, route, cluster):
    """R1's and R2's widths take K11L in clusters of 8 (128 KB and 80 KB of
    RW a CTA), wider layers clusters of 16 (non-portable) up to the
    widest whose backward fits a block's 227 KB, past it K11 a step; the
    same widths with an activation K11 lacks take the plain step."""
    assert rc.layer_cluster(hd) == cluster
    layer = TL.LSTM(n_in=C, n_out=hd, activation="tanh")
    assert layer.cell_route() == route
    assert TL.GravesLSTM(n_in=C, n_out=hd,
                         activation="elu").cell_route() == "step"
    if cluster is not None:
        for which in ("fwd", "bwd"):
            geo = rc.layer_geometry(which, hd, cluster, rc.LAYER_ROWS)
            assert geo["smem"] <= rc.SMEM_PER_BLOCK
            assert rc.LAYER_ROWS * geo["units"] <= rc.LAYER_THREADS
            assert 1 <= geo["ks"] and geo["ks"] * geo["ncb"] <= 8


def test_the_limit_is_the_backward_shared_memory():
    """Past MAX_LAYER_HIDDEN the backward's block (4H rows of the CTA's RW
    columns, two dz buffers, the shares) passes 227 KB at 16 CTAs; at R1's
    width the two blocks take 140 KB and 164 KB of it."""
    past = rc.layer_geometry("bwd", rc.MAX_LAYER_HIDDEN + 1, 16,
                             rc.LAYER_ROWS)
    assert past["smem"] > rc.SMEM_PER_BLOCK
    assert rc.layer_geometry("fwd", rc.MAX_LAYER_HIDDEN + 1, 16,
                             rc.LAYER_ROWS)["smem"] <= rc.SMEM_PER_BLOCK
    r1 = [rc.layer_geometry(w, 256, 8, 4) for w in ("fwd", "bwd")]
    assert [g["smem"] for g in r1] == [143360, 167936]
    assert [(g["units"], g["oc"], g["ks"], g["chunk"]) for g in r1] == [
        (32, 128, 2, 128), (32, 32, 8, 128)]
    assert [rc.layer_rows(n) for n in (1, 8, 9, 16, 17, 32, 64)] == [
        1, 1, 2, 2, 4, 4, 4]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("peep", [False, True], ids=["LSTM", "GravesLSTM"])
def test_layer_wrappers_take_the_plain_version_on_the_cpu(peep, masked):
    ops, dy, dh, dc = _operands(peep, masked, 3)
    before = rc.launches_layer_fwd, rc.launches_layer_bwd
    got = rc.lstm_layer_fwd(**ops, act=0)
    want = rc.layer_fwd_reference(**ops, act=0)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    args = (dy, dh, dc, want[3], want[2], ops["c0"], ops["rw"], ops["peep"],
            ops["m"], 0)
    for a, b in zip(rc.lstm_layer_bwd(*args), rc.layer_bwd_reference(*args)):
        assert (a is None and b is None) or torch.equal(a, b)
    assert (rc.launches_layer_fwd, rc.launches_layer_bwd) == before


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("peep", [False, True], ids=["LSTM", "GravesLSTM"])
def test_both_kernel_routes_give_the_same_bits_on_the_cpu(monkeypatch, peep,
                                                          masked):
    """The "k11" route (a step at a time) and "k11_layer" (the layer's
    plain version) run the same ops on the CPU: equal outputs, carries
    and gradients, bit for bit."""
    layer = _layer(TL, peep, "tanh")
    g = torch.Generator().manual_seed(21)
    params = {k: torch.randn(s, generator=g) * 0.5
              for k, s in layer.param_shapes().items()}
    x = torch.randn((N, T, C), generator=g)
    mask = torch.tensor(_mask()) if masked else None

    def run(route):
        monkeypatch.setattr(layer, "cell_route", lambda: route)
        ps = {k: v.clone().requires_grad_() for k, v in params.items()}
        xs = x.clone().requires_grad_()
        y, (h, c) = layer.run(ps, xs, layer.initial_carry(N), mask=mask)
        grads = torch.autograd.grad(y.square().sum() + h.sum() + c.sum(),
                                    [*ps.values(), xs])
        return [y, h, c, *grads]

    for a, b in zip(run("k11"), run("k11_layer")):
        assert torch.equal(a, b)


def test_rnn_time_step_is_a_one_step_layer_call(monkeypatch):
    """``rnnTimeStep`` runs each LSTM layer as one T = 1 call of the layer
    Function on the "k11_layer" route: one ``lstm_layer_fwd`` a layer and
    character, the output equal to ``output()`` over the sequence."""
    from deeplearning4j_tpu_torch.nn.conf.configuration import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(3).list()
            .layer(TL.LSTM(n_in=C, n_out=H, activation="tanh"))
            .layer(TL.GravesLSTM(n_out=H, activation="tanh"))
            .layer(TL.RnnOutputLayer(n_out=4, activation="softmax",
                                     loss_function="mcxent"))
            .set_input_type(InputType.recurrent(C)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    calls = []
    fwd = rc.lstm_layer_fwd

    def spy(xw, *a):
        calls.append(xw.shape[0])
        return fwd(xw, *a)

    monkeypatch.setattr(rc, "lstm_layer_fwd", spy)
    x = np.random.default_rng(5).standard_normal((2, 4, C)).astype(
        np.float32)
    full = net.output(x)
    assert calls == [4, 4]
    calls.clear()
    steps = torch.stack([net.rnnTimeStep(x[:, t]) for t in range(4)], 1)
    assert calls == [1] * 8
    torch.testing.assert_close(steps, full, rtol=0, atol=1e-6)
