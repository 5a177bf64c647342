"""The port's HTTP/SSE front door against the JAX package's.

Each test starts a ``FrontDoor`` of each package over the same tiny f32
``TransformerLM`` (``deploy_generative``, weights from
``from_jax_params``) and sends both the same requests: the greedy tokens
are exact and equal the JAX engine's; the SSE ``id:`` sequences and event
bodies are equal (apart from the minted session id and the worker name);
a streamed generation equals the plain one; statuses 400/404/409/413/429/
503/504 map the same; every response carries ``X-Dl4j-Trace-Id``; a
client that drops its stream frees its slot with the typed
``client_gone`` shed; and ``DL4J_TPU_FRONTDOOR=0`` answers 503 on
``/v1/*`` while the debug surfaces stay up. Every door is stopped in a
``finally`` and every socket has a timeout.
"""
import http.client
import json
import socket
import struct
import time
import urllib.error
import urllib.request

import pytest

from _torch_serving import (BOTH, JAX, TIMEOUT_S, TORCH, engine, get, greedy,
                            http_call, prompt, reset_all, sse, strip_volatile,
                            teardown_all)


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    teardown_all()


class _Doors:
    """A generative door of each package; stops them all on exit."""

    def __init__(self, slots=2, max_new=16, **fd_kw):
        self.slots, self.max_new, self.fd_kw = slots, max_new, fd_kw
        self.made = []

    def __enter__(self):
        self.doors = {}
        for pkg in BOTH:
            reg = pkg.registry.ModelRegistry()
            self.made.append((reg, None))
            reg.deploy_generative("g1", engine(pkg), slots=self.slots,
                                  max_new_tokens=self.max_new)
            router = pkg.router.ServingRouter(reg, "g1")
            fd = pkg.frontdoor.FrontDoor(gen_router=router, port=0,
                                         **self.fd_kw).start()
            self.made[-1] = (reg, fd)
            self.doors[pkg.name] = (reg, router, fd)
        return self

    def __exit__(self, *exc):
        for reg, fd in self.made:
            if fd is not None:
                fd.stop()
            reg.shutdown()

    def each(self):
        for pkg in BOTH:
            yield pkg, self.doors[pkg.name]

    def addr(self, pkg):
        return self.doors[pkg.name][2].get_address()


@pytest.mark.parametrize("case", [(7, 1, 16), (3, 2, 9), (20, 3, 12)])
def test_plain_and_streamed_tokens_equal_the_reference(case):
    n, seed, new = case
    doc = {"prompt": prompt(n, seed).tolist(), "max_new_tokens": new}
    want = greedy(doc["prompt"], new)
    got = {}
    with _Doors() as doors:
        for pkg, _ in doors.each():
            addr = doors.addr(pkg)
            code, plain, headers = http_call(addr, "/v1/generate", doc)
            assert code == 200 and headers.get("X-Dl4j-Trace-Id")
            ids, toks, done, error, events, _h = sse(addr, doc)
            assert error is None
            assert toks == plain["tokens"] == done["tokens"] == want
            assert ids == list(range(new))
            got[pkg.name] = (strip_volatile(plain),
                             [(e, strip_volatile(d)) for e, d in events])
    assert got["torch"] == got["jax"]


def test_status_mapping_matches_the_reference():
    """400 (malformed, missing field), 404 (route, /v1/classify with no
    scoring lane, an unknown rollout candidate), 409 (a second rollout),
    413, 429 (max_inflight 0) with Retry-After, 504 (a 1e-6 ms deadline),
    503 (a retired version); every reply carries the trace header."""
    seen = {}
    with _Doors() as doors:
        for pkg, (reg, router, fd) in doors.each():
            addr = doors.addr(pkg)
            out = []

            def note(code, body, headers):
                assert headers.get("X-Dl4j-Trace-Id"), (pkg.name, code)
                out.append((code, body.get("error")))

            req = urllib.request.Request(addr + "/v1/generate",
                                         data=b"not json")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=TIMEOUT_S)
            out.append((ei.value.code, None))
            note(*http_call(addr, "/v1/generate", {"nope": 1}))
            note(*http_call(addr, "/v1/nope", {}))
            note(*http_call(addr, "/v1/classify", {"inputs": [[0.0] * 4]}))
            note(*http_call(addr, "/admin/rollout",
                       {"lane": "generative", "candidate": "nope"}))
            reg.deploy_generative("g2", engine(pkg), slots=2,
                                  warmup=False)
            note(*http_call(addr, "/admin/rollout",
                       {"lane": "generative", "candidate": "g2",
                        "policy": {"start_stage": "shadow"}}))
            note(*http_call(addr, "/admin/rollout",
                       {"lane": "generative", "candidate": "g2"}))
            note(*http_call(addr, "/admin/rollback",
                       {"lane": "generative", "reason": "test"}))
            conn = http.client.HTTPConnection("127.0.0.1", fd.port,
                                              timeout=TIMEOUT_S)
            try:
                conn.putrequest("POST", "/v1/generate")
                conn.putheader("Content-Length", str(10 ** 10))
                conn.endheaders()
                out.append((conn.getresponse().status, None))
            finally:
                conn.close()
            note(*http_call(addr, "/v1/generate",
                       {"prompt": [1, 2, 3], "deadline_ms": 1e-6}))
            fd2 = pkg.frontdoor.FrontDoor(gen_router=router, port=0,
                                          max_inflight=0).start()
            try:
                code, body, headers = http_call(fd2.get_address(),
                                           "/v1/generate",
                                           {"prompt": [1, 2, 3]})
                note(code, body, headers)
                assert headers.get("Retry-After") == "1"
            finally:
                fd2.stop()
            reg.retire("g1")
            note(*http_call(addr, "/v1/generate", {"prompt": [1, 2, 3]}))
            seen[pkg.name] = out
    assert seen["torch"] == seen["jax"]
    assert [c for c, _ in seen["torch"]] == [
        400, 400, 404, 404, 404, 200, 409, 200, 413, 504, 429, 503]


def test_client_disconnect_mid_stream_frees_the_slot_typed():
    """A client that resets its SSE connection mid-stream cancels its
    request at a step boundary: the slot frees with the typed
    ``client_gone`` shed in both packages, and the door keeps serving."""
    with _Doors() as doors:
        for pkg, (reg, _router, fd) in doors.each():
            gp = reg.get("g1").gp
            payload = json.dumps({"prompt": [3, 1, 4, 1, 5, 9, 2],
                                  "max_new_tokens": 40,
                                  "stream": True}).encode()
            s = socket.create_connection(("127.0.0.1", fd.port),
                                         timeout=TIMEOUT_S)
            try:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                             struct.pack("ii", 1, 0))
                s.sendall(b"POST /v1/generate HTTP/1.1\r\n"
                          b"Host: x\r\nContent-Type: application/json\r\n"
                          + f"Content-Length: {len(payload)}\r\n\r\n"
                          .encode() + payload)
                buf = b""
                while b"event: token" not in buf:
                    chunk = s.recv(4096)
                    assert chunk, f"stream ended early: {buf!r}"
                    buf += chunk
            finally:
                s.close()
            deadline = time.monotonic() + TIMEOUT_S
            while (gp.snapshot()["active"] != 0
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert gp.snapshot()["active"] == 0
            shed = pkg.obs.global_registry().get("dl4j_decode_shed_total")
            got = {lv[0]: c.value for lv, c in shed.series()}
            assert got.get("client_gone", 0) >= 1, (pkg.name, got)
            code, body, _ = http_call(fd.get_address(), "/v1/generate",
                                 {"prompt": [1, 2, 3],
                                  "max_new_tokens": 4})
            assert code == 200 and body["tokens"] == greedy([1, 2, 3], 4)


def test_kill_switch_answers_503_and_spares_debug(monkeypatch):
    seen = {}
    with _Doors() as doors:
        monkeypatch.setenv("DL4J_TPU_FRONTDOOR", "0")
        for pkg, _ in doors.each():
            addr = doors.addr(pkg)
            code, body, headers = http_call(addr, "/v1/generate",
                                       {"prompt": [1, 2]})
            snap_code, snap = get(addr, "/debug/frontdoor")
            seen[pkg.name] = (code, body, headers.get("Retry-After"),
                              snap_code, snap["enabled"])
        monkeypatch.delenv("DL4J_TPU_FRONTDOOR")
        for pkg, _ in doors.each():
            code, body, _ = http_call(doors.addr(pkg), "/v1/generate",
                                 {"prompt": [1, 2], "max_new_tokens": 3})
            assert code == 200 and body["tokens"] == greedy([1, 2], 3)
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0] == 503
    assert seen["torch"][1]["error"] == "FrontDoorDisabled"
    assert seen["torch"][3:] == (200, False)


def test_debug_surfaces_answer_with_the_reference_keys():
    """Every ``/debug/*`` route of the door answers in both packages with
    the same status and the same top-level keys."""
    paths = ["/debug/frontdoor", "/debug/tenants",
             "/debug/sessions", "/debug/fleet", "/debug/timeseries",
             "/debug/alerts", "/debug/trace", "/health", "/metrics"]
    seen = {}
    with _Doors() as doors:
        for pkg, _ in doors.each():
            addr = doors.addr(pkg)
            http_call(addr, "/v1/generate", {"prompt": [4, 2],
                                        "max_new_tokens": 2})
            out = {}
            for p in paths:
                if p == "/metrics":
                    with urllib.request.urlopen(addr + p,
                                                timeout=TIMEOUT_S) as r:
                        names = {ln.split("{")[0].split(" ")[0]
                                 for ln in r.read().decode().splitlines()
                                 if ln.startswith("dl4j_http_")}
                        out[p] = (r.status, sorted(names))
                else:
                    code, body = get(addr, p)
                    out[p] = (code, sorted(body))
            seen[pkg.name] = out
    assert seen["torch"] == seen["jax"]
    assert all(code == 200 for code, _ in seen["torch"].values()), seen


def test_frontdoor_http_status_table_is_the_reference():
    from deeplearning4j_tpu.resilience import policy as jpol
    from deeplearning4j_tpu_torch.resilience import policy as tpol
    cases = [("ShedError", 429), ("DeadlineExceeded", 504),
             ("CircuitOpenError", 503), ("ShutdownError", 503)]
    for name, code in cases:
        assert (TORCH.frontdoor.http_status(getattr(tpol, name)("x"))
                == JAX.frontdoor.http_status(getattr(jpol, name)("x"))
                == code)
    for exc, code in [(KeyError("v"), 404), (ValueError("v"), 400),
                      (RuntimeError("v"), 500),
                      (TORCH.frontdoor.PayloadTooLarge("v"), 413)]:
        assert TORCH.frontdoor.http_status(exc) == code
    assert (TORCH.frontdoor.http_status(
        TORCH.serving.RolloutConflictError("x")) == 409)
