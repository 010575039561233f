"""The port's online-learning sources against the JAX package's, on the
CPU, over real sockets on localhost.

Message sets and requests must be the reference's bytes; the port's
client must work against the reference's stub broker and the
reference's client against the port's; a ``FileChannel`` spool written
by one package must read in the other; ``CriteoFeatureEngineer`` must
give the reference's batches.  Every socket here has a timeout (the
clients' 10 s, the stub's poll), and a stopped stub ends its threads."""

import json
import sys
import threading

import numpy as np
import pytest

from mindrec_tpu.data import kafka_stub as jstub
from mindrec_tpu.data import kafka_wire as jkw
from mindrec_tpu.data import preprocess as jpre
from mindrec_tpu.data import streaming as jstreaming
from mindrec_tpu_torch.data import kafka_stub, kafka_wire, preprocess, streaming

N_DENSE, N_CAT = preprocess.N_DENSE, preprocess.N_CAT


@pytest.fixture(autouse=True)
def _in_repo_clients(monkeypatch):
    """The stub speaks only the v0 subset: never pick kafka-python."""
    monkeypatch.setitem(sys.modules, "kafka", None)
    monkeypatch.setitem(sys.modules, "kafka.admin", None)


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append([str(int(rng.uniform() > 0.7))]
                   + [str(int(rng.integers(0, 50))) if rng.uniform() > 0.1
                      else "" for _ in range(N_DENSE)]
                   + [f"v{int(rng.integers(0, 5))}" for _ in range(N_CAT)])
    return out


def test_message_sets_match_reference():
    vals = [b"a", b"hello world", b"", b"x" * 1000, json.dumps(_rows(3)).encode()]
    for base in (0, 7):
        data = kafka_wire.encode_message_set(vals, base_offset=base)
        assert data == jkw.encode_message_set(vals, base_offset=base)
        assert kafka_wire.decode_message_set(data) == \
            jkw.decode_message_set(data)
    assert kafka_wire.encode_message(b"v", b"k") == jkw.encode_message(b"v", b"k")
    assert kafka_wire.decode_message_set(data[:-3]) == \
        jkw.decode_message_set(data[:-3])
    bad = bytearray(data)
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        kafka_wire.decode_message_set(bytes(bad))


@pytest.mark.parametrize("stub_of,client_of", [("ref", "port"),
                                               ("port", "ref")])
def test_client_against_other_packages_stub(stub_of, client_of):
    stub_mod = jstub if stub_of == "ref" else kafka_stub
    kw = kafka_wire if client_of == "port" else jkw
    broker = stub_mod.StubKafkaBroker()
    bootstrap = broker.start()
    try:
        c = kw.MiniKafkaClient(bootstrap, timeout=10.0)
        assert c.create_topic("t", num_partitions=2) == 0
        assert c.create_topic("t", num_partitions=2) == 36  # exists
        md = c.metadata(["t", "nope"])
        assert md["t"]["error"] == 0 and set(md["t"]["partitions"]) == {0, 1}
        assert md["nope"]["error"] == 3
        assert c.produce("t", 1, [b"m0", b"m1"]) == 0
        assert c.produce("t", 1, [b"m2"]) == 2
        hw, recs = c.fetch("t", 1, 1)
        assert hw == 3 and recs == [(1, b"m1"), (2, b"m2")]
        hw, recs = c.fetch("t", 1, 0, max_bytes=40)  # truncated tail
        assert hw == 3 and recs == [(0, b"m0")]
        c.close()
        prod = kw.MiniKafkaProducer(
            bootstrap, value_serializer=lambda v: json.dumps(v).encode())
        for p in range(2):
            for i in range(4):
                prod.send("t2", value={"p": p, "i": i}, partition=p)
        prod.close()
        cons = kw.MiniKafkaConsumer(bootstrap, consumer_timeout_ms=300,
                                    auto_offset_reset="earliest")
        cons.assign([("t2", 0), ("t2", 1)])
        got = [json.loads(r.value) for r in cons]
        cons.close()
        assert sorted((g["p"], g["i"]) for g in got) == [
            (p, i) for p in range(2) for i in range(4)]
        assert broker.log("t2", 1) == [json.dumps({"p": 1, "i": i}).encode()
                                       for i in range(4)]
    finally:
        broker.stop()


def test_kafka_source_and_create_topic_match_reference():
    """The port's create_topic + KafkaSource over the port's stub yield
    the reference's source's lists from the reference's stub."""
    msgs = [json.dumps(r).encode() for r in _rows(7, seed=2)]
    outs = []
    for stub_mod, smod in ((kafka_stub, streaming), (jstub, jstreaming)):
        with stub_mod.StubKafkaBroker() as bootstrap:
            smod.create_topic("s", num_partitions=2,
                              bootstrap_servers=bootstrap)
            smod.create_topic("s", num_partitions=2,
                              bootstrap_servers=bootstrap)  # exists: no error
            c = kafka_wire.MiniKafkaClient(bootstrap)
            for i, m in enumerate(msgs):
                c.produce("s", i % 2, [m])
            c.close()
            src = smod.KafkaSource("s", [0, 1], bootstrap_servers=bootstrap,
                                   count=3, idle_timeout_ms=300,
                                   auto_offset_reset="earliest")
            outs.append(list(src))
            src._consumer.close()
    assert outs[0] == outs[1] and sum(map(len, outs[0])) == 7


def test_consumer_starts_at_log_end_by_default():
    with kafka_stub.StubKafkaBroker() as bootstrap:
        c = kafka_wire.MiniKafkaClient(bootstrap)
        c.produce("late", 0, [b"old"])
        cons = kafka_wire.MiniKafkaConsumer(bootstrap, consumer_timeout_ms=300)
        cons.assign([("late", 0)])
        c.produce("late", 0, [b"new"])
        assert [r.value for r in cons] == [b"new"]
        cons.close()
        c.close()


def test_stopped_stub_ends_its_threads():
    broker = kafka_stub.StubKafkaBroker(poll_s=0.05)
    bootstrap = broker.start()
    clients = [kafka_wire.MiniKafkaClient(bootstrap) for _ in range(3)]
    for c in clients:
        c.metadata([])
    broker.stop(timeout=5.0)
    assert not broker._accept_thread.is_alive()
    assert len(broker._threads) == 3
    assert not any(t.is_alive() for t in broker._threads)
    with pytest.raises(OSError):
        clients[0].metadata([])
    for c in clients:
        c.close()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_file_channel_cross_package(tmp_path, writer):
    rng = np.random.default_rng(1)
    batches = [{"ids": rng.integers(0, 100, (8, 3)).astype(np.int32),
                "wts": rng.uniform(size=(8, 3)).astype(np.float32),
                "label": rng.integers(0, 2, (8, 1)).astype(np.float32)}
               for _ in range(5)]
    wmod, rmod = ((streaming, jstreaming) if writer == "port"
                  else (jstreaming, streaming))
    ch = wmod.FileChannel(tmp_path, num_shards=2)
    sender = ch.sender()
    for b in batches:
        sender.send(b)
    sender.close()
    rch = rmod.FileChannel(tmp_path, num_shards=2, poll_s=0.01)
    for shard in range(2):
        got = list(rmod.StreamingDataset(rch.receiver(shard)))
        want = batches[shard::2]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    r = streaming.FileChannel(tmp_path / "empty", poll_s=0.01).receiver(0)
    with pytest.raises(streaming.queue_mod.Empty):
        r.recv(timeout=0.05)


def test_channel_and_feeder_match_reference():
    items = list(range(11))
    outs = []
    for smod in (streaming, jstreaming):
        ch = smod.Channel(num_shards=3, capacity=4)
        t = smod.feed_channel_from_iterator(iter(items), ch)
        got = [list(smod.StreamingDataset(ch.receiver(s))) for s in range(3)]
        t.join(timeout=10)
        assert not t.is_alive()
        outs.append(got)
    assert outs[0] == outs[1] == [items[0::3], items[1::3], items[2::3]]
    assert len(streaming.StreamingDataset(None)) == 2**20 - 1


def test_feature_engineer_matches_reference(tmp_path):
    rows = _rows(300, seed=5)
    tsv = tmp_path / "d.tsv"
    tsv.write_text("".join("\t".join(r) + "\n" for r in rows))
    stats = jpre.collect_stats([str(tsv)], workers=1)
    got = streaming.CriteoFeatureEngineer(stats)(rows[:64])
    want = jstreaming.CriteoFeatureEngineer(stats)(rows[:64])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    assert got["ids"].max() < stats.vocab_size


def test_producer_threads_and_consumer_do_not_hang():
    """Two producer threads and a consumer thread over the port's stub,
    each join bounded."""
    with kafka_stub.StubKafkaBroker() as bootstrap:
        streaming.create_topic("p", 2, bootstrap_servers=bootstrap)

        def produce(part):
            prod = kafka_wire.MiniKafkaProducer(bootstrap)
            for i in range(20):
                prod.send("p", value=f"{part}:{i}".encode(), partition=part)
            prod.close()

        src = streaming.KafkaSource("p", [0, 1], bootstrap_servers=bootstrap,
                                    count=5, idle_timeout_ms=500)
        got = []
        cons = threading.Thread(target=lambda: got.extend(src))
        prods = [threading.Thread(target=produce, args=(p,)) for p in (0, 1)]
        cons.start()
        for t in prods:
            t.start()
        for t in prods + [cons]:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in prods + [cons])
        src._consumer.close()
    vals = sorted(v for batch in got for v in batch)
    assert vals == sorted(f"{p}:{i}".encode() for p in (0, 1)
                          for i in range(20))
