"""On-device sampler + fully-jitted epoch pipeline tests.

Mirrors the sampler shape-invariant tests of the reference
(``/root/reference/dgll/sampling/unittest_smapler.py:11-53``) for the
device-resident path, plus semantic checks the reference lacks: every
masked-valid sampled id is a true in-neighbour, zero-degree rows fall back to
self with mask 0, and the scanned epoch actually learns.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from dgll_tpu.graph import Graph
from dgll_tpu.nn import GraphSAGE
from dgll_tpu.sampling.device_sampler import (
    DeviceCSR,
    DeviceNeighborSampler,
    sample_blocks_device,
    sample_layer_device,
)
from dgll_tpu.train.device_pipeline import DeviceEpochRunner


def _random_graph(n=64, e=512, seed=0, with_isolated=True):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    if with_isolated:  # make node 0 isolated (no in-edges)
        dst = np.where(dst == 0, 1, dst)
    g = Graph.from_edges(src, dst, n)
    return g, src, dst


def _in_neighbors(g):
    indptr = np.asarray(g.indptr)
    src = np.asarray(g.src)
    return {v: set(src[indptr[v]:indptr[v + 1]].tolist()) for v in range(g.n_node)}


class TestSampleLayerDevice:
    def test_sampled_are_neighbors(self):
        g, _, _ = _random_graph()
        csr = DeviceCSR.from_graph(g)
        nbrs = _in_neighbors(g)
        frontier = jnp.arange(g.n_node, dtype=jnp.int32)
        fmask = jnp.ones(g.n_node, bool)
        sampled, mask = sample_layer_device(csr, frontier, fmask, 7, jax.random.key(0))
        sampled, mask = np.asarray(sampled), np.asarray(mask)
        assert sampled.shape == (g.n_node, 7) and mask.shape == (g.n_node, 7)
        for v in range(g.n_node):
            if nbrs[v]:
                assert mask[v].all()
                assert set(sampled[v].tolist()) <= nbrs[v]
            else:  # zero-degree: self fallback, mask 0
                assert not mask[v].any()
                assert (sampled[v] == v).all()

    def test_masked_rows_emit_self(self):
        g, _, _ = _random_graph()
        csr = DeviceCSR.from_graph(g)
        frontier = jnp.arange(8, dtype=jnp.int32) + 1
        fmask = jnp.array([True, False] * 4)
        sampled, mask = sample_layer_device(csr, frontier, fmask, 3, jax.random.key(1))
        mask = np.asarray(mask)
        assert not mask[1::2].any()
        assert (np.asarray(sampled)[1::2] == np.asarray(frontier)[1::2, None]).all()

    def test_deterministic_per_key(self):
        g, _, _ = _random_graph()
        csr = DeviceCSR.from_graph(g)
        f = jnp.arange(16, dtype=jnp.int32)
        m = jnp.ones(16, bool)
        s1, _ = sample_layer_device(csr, f, m, 5, jax.random.key(7))
        s2, _ = sample_layer_device(csr, f, m, 5, jax.random.key(7))
        s3, _ = sample_layer_device(csr, f, m, 5, jax.random.key(8))
        assert (np.asarray(s1) == np.asarray(s2)).all()
        assert (np.asarray(s1) != np.asarray(s3)).any()


class TestSampleBlocksDevice:
    def test_block_shapes_and_order(self):
        g, _, _ = _random_graph()
        csr = DeviceCSR.from_graph(g)
        b = 16
        seeds = jnp.arange(b, dtype=jnp.int32) + 1
        inp, out, blocks = sample_blocks_device(
            csr, seeds, jnp.ones(b, bool), [4, 3], jax.random.key(0)
        )
        assert len(blocks) == 2
        # innermost (seed-side) block is blocks[-1]: n_dst == batch
        assert blocks[-1].n_dst == b and blocks[-1].fanout == 3
        # outermost block's dst = innermost block's src frontier
        assert blocks[0].n_dst == b * (1 + 3) and blocks[0].fanout == 4
        assert inp.shape[0] == blocks[0].n_src
        assert (np.asarray(out) == np.asarray(seeds)).all()
        # self-at-head layout
        assert (np.asarray(blocks[-1].src_ids[:b]) == np.asarray(seeds)).all()

    def test_jittable(self):
        g, _, _ = _random_graph()
        csr = DeviceCSR.from_graph(g)
        b = 8

        @jax.jit
        def run(csr, seeds, key):
            _, _, blocks = sample_blocks_device(
                csr, seeds, jnp.ones(b, bool), [4, 3], key
            )
            return blocks[0].src_ids

        ids = run(csr, jnp.arange(b, dtype=jnp.int32), jax.random.key(0))
        # inner frontier = 8*(1+3) = 32; block0 n_src = 32*(1+4) = 160
        assert ids.shape[0] == 160

    def test_empty_fanouts_identity(self):
        g, _, _ = _random_graph()
        csr = DeviceCSR.from_graph(g)
        seeds = jnp.arange(4, dtype=jnp.int32)
        inp, out, blocks = sample_blocks_device(
            csr, seeds, jnp.ones(4, bool), [], jax.random.key(0)
        )
        assert blocks == [] and (np.asarray(inp) == np.asarray(seeds)).all()

    def test_wrapper_class(self):
        g, _, _ = _random_graph()
        csr = DeviceCSR.from_graph(g)
        s = DeviceNeighborSampler([5, 2])
        inp, out, blocks = s.sample(csr, np.arange(10), jax.random.key(3))
        assert len(blocks) == 2 and blocks[-1].n_dst == 10


class TestDeviceEpochRunner:
    def test_learns_and_single_dispatch(self):
        # separable 2-class task on a clustered graph
        rng = np.random.default_rng(0)
        n = 256
        label = (np.arange(n) >= n // 2).astype(np.int32)
        # intra-class edges only
        src, dst = [], []
        for _ in range(8):
            a = rng.permutation(n // 2)
            src += [a, a + n // 2]
            dst += [np.roll(a, 1), np.roll(a, 1) + n // 2]
        src, dst = np.concatenate(src), np.concatenate(dst)
        g = Graph.from_edges(src, dst, n, add_self_loops=True)
        csr = DeviceCSR.from_graph(g)
        feats = jnp.asarray(
            rng.standard_normal((n, 16)).astype(np.float32)
            + label[:, None] * np.float32(1.5)
        )
        labels = jnp.asarray(label)

        model = GraphSAGE(hidden=32, n_class=2, dropout=0.0)
        runner = DeviceEpochRunner(
            model, optax.adam(1e-2), csr, fanouts=[5, 5], batch_size=64,
            train_nodes=np.arange(n), seed=0,
        )
        state = runner.init_state(feats)
        state, loss0 = runner.run_epoch(state, feats, labels)
        for _ in range(5):
            state, loss = runner.run_epoch(state, feats, labels)
        assert float(loss) < float(loss0)
        assert float(loss) < 0.3

    def test_padded_seed_masking(self):
        g, _, _ = _random_graph(32, 128)
        csr = DeviceCSR.from_graph(g)
        feats = jnp.ones((32, 4), jnp.float32)
        labels = jnp.zeros(32, jnp.int32)
        model = GraphSAGE(hidden=8, n_class=2, n_layers=1, dropout=0.0)
        # 10 train nodes, batch 8 -> 2 batches, 6 padded slots
        runner = DeviceEpochRunner(
            model, optax.sgd(0.1), csr, fanouts=[3], batch_size=8,
            train_nodes=np.arange(10),
        )
        assert runner.n_batches == 2
        assert int(np.asarray(runner.seed_mask).sum()) == 10
        state = runner.init_state(feats)
        state, loss = runner.run_epoch(state, feats, labels)
        assert np.isfinite(float(loss))


class TestWindowSampling:
    def test_sampled_are_neighbors(self):
        g, _, _ = _random_graph(96, 800, seed=3)
        csr = DeviceCSR.from_graph(g)
        nbrs = _in_neighbors(g)
        frontier = jnp.arange(g.n_node, dtype=jnp.int32)
        fmask = jnp.ones(g.n_node, bool)
        sampled, mask = sample_layer_device(
            csr, frontier, fmask, 6, jax.random.key(0), window=True)
        sampled, mask = np.asarray(sampled), np.asarray(mask)
        for v in range(g.n_node):
            if nbrs[v]:
                assert mask[v].all()
                assert set(sampled[v].tolist()) <= nbrs[v], v
            else:
                assert not mask[v].any()
                assert (sampled[v] == v).all()

    def test_marginal_uniformity(self):
        # one node with many neighbours spanning several LANE windows: each
        # neighbour must be drawn ~uniformly across repeated keys
        n_nbr = 300  # spans 3+ packed windows
        src = np.arange(1, n_nbr + 1, dtype=np.int64)
        dst = np.zeros(n_nbr, np.int64)
        from dgll_tpu.graph import Graph

        g = Graph.from_edges(src, dst, n_nbr + 1)
        csr = DeviceCSR.from_graph(g)
        frontier = jnp.zeros(1, jnp.int32)
        fmask = jnp.ones(1, bool)

        @jax.jit
        def draw(key):
            s, _ = sample_layer_device(csr, frontier, fmask, 8, key, window=True)
            return s

        counts = np.zeros(n_nbr + 2, np.int64)
        reps = 2000
        for r in range(reps):
            s = np.asarray(draw(jax.random.key(r)))
            np.add.at(counts, s.reshape(-1), 1)
        freq = counts[1 : n_nbr + 1] / (reps * 8)
        expect = 1.0 / n_nbr
        # every neighbour visited; frequencies within 4x of uniform (loose
        # bound: 16000 draws over 300 outcomes, ~53 expected hits each)
        assert (counts[1 : n_nbr + 1] > 0).all()
        assert freq.max() < 4 * expect and freq.min() > expect / 4
        # chi-square-ish sanity: relative std under 60%
        assert freq.std() / expect < 0.6

    def test_epoch_runner_window_learns(self):
        rng = np.random.default_rng(1)
        n = 256
        label = (np.arange(n) >= n // 2).astype(np.int32)
        src, dst = [], []
        for _ in range(8):
            a = rng.permutation(n // 2)
            src += [a, a + n // 2]
            dst += [np.roll(a, 1), np.roll(a, 1) + n // 2]
        src, dst = np.concatenate(src), np.concatenate(dst)
        g = Graph.from_edges(src, dst, n, add_self_loops=True)
        csr = DeviceCSR.from_graph(g)
        feats = jnp.asarray(
            rng.standard_normal((n, 16)).astype(np.float32)
            + label[:, None] * np.float32(1.5))
        labels = jnp.asarray(label)
        model = GraphSAGE(hidden=32, n_class=2, dropout=0.0)
        runner = DeviceEpochRunner(model, optax.adam(1e-2), csr, fanouts=[5, 5],
                                   batch_size=64, train_nodes=np.arange(n),
                                   seed=0, window=True)
        state = runner.init_state(feats)
        state, loss0 = runner.run_epoch(state, feats, labels)
        for _ in range(5):
            state, loss = runner.run_epoch(state, feats, labels)
        assert float(loss) < float(loss0) and float(loss) < 0.35


class TestDeviceDPEpochRunner:
    def test_dp_device_sampling_learns_on_mesh(self):
        """On-device sampling composed with data parallelism: each of 4 mesh
        devices samples its sub-batch from the replicated HBM CSR inside the
        scanned epoch program; grads are pmean'd."""
        import jax
        from dgll_tpu.parallel import make_mesh
        from dgll_tpu.train.device_pipeline import DeviceDPEpochRunner

        rng = np.random.default_rng(0)
        n = 256
        label = (np.arange(n) >= n // 2).astype(np.int32)
        src, dst = [], []
        for _ in range(8):
            a = rng.permutation(n // 2)
            src += [a, a + n // 2]
            dst += [np.roll(a, 1), np.roll(a, 1) + n // 2]
        src, dst = np.concatenate(src), np.concatenate(dst)
        g = Graph.from_edges(src, dst, n, add_self_loops=True)
        csr = DeviceCSR.from_graph(g)
        feats = jnp.asarray(
            rng.standard_normal((n, 16)).astype(np.float32)
            + label[:, None] * np.float32(1.5))
        labels = jnp.asarray(label)

        mesh = make_mesh(("data",), devices=jax.devices()[:4])
        model = GraphSAGE(hidden=32, n_class=2, dropout=0.0)
        runner = DeviceDPEpochRunner(
            model, optax.adam(1e-2), csr, fanouts=[5, 5], per_device_batch=16,
            train_nodes=np.arange(n), mesh=mesh, seed=0, window=True)
        assert runner.batch_size == 64  # 4 devices x 16
        state = runner.init_state(feats)
        state, loss0 = runner.run_epoch(state, feats, labels)
        for _ in range(5):
            state, loss = runner.run_epoch(state, feats, labels)
        assert float(loss) < float(loss0)
        assert float(loss) < 0.35
        # the epoch compiled once: the first state is placed like the ones
        # the epoch returns
        assert runner.epoch_fn._cache_size() == 1


class TestCompiledEval:
    """Compiled evaluation sweep (make_device_eval_fn): the val/test half of the
    device-resident pipeline — one scanned dispatch per node set, no host
    DataLoader (ref folds validation into its pipeline at buffer_queues.py:47-61
    but still samples on the host)."""

    def _setup(self):
        from dgll_tpu.data import synthetic_classification_graph

        g = synthetic_classification_graph(n_node=300, avg_degree=8, feat_dim=16,
                                           n_class=4, seed=7, homophily=0.95)
        csr = DeviceCSR.from_graph(g)
        model = GraphSAGE(hidden=16, n_class=4, dropout=0.0)
        runner = DeviceEpochRunner(model, optax.adam(3e-2), csr, fanouts=[6, 4],
                                   batch_size=32,
                                   train_nodes=g.get_train_nodes(), seed=0)
        return g, runner

    def test_predictions_deterministic_and_shaped(self):
        g, runner = self._setup()
        feats = jnp.asarray(g.node_feat)
        state = runner.init_state(feats)
        nodes = np.arange(50)
        p1 = runner.predict_nodes(state, feats, nodes, seed=3)
        p2 = runner.predict_nodes(state, feats, nodes, seed=3)
        assert p1.shape == (50,)
        np.testing.assert_array_equal(p1, p2)  # same seed -> same sweep

    def test_eval_tracks_training(self):
        g, runner = self._setup()
        feats = jnp.asarray(g.node_feat)
        labels = jnp.asarray(g.labels)
        labels_np = np.asarray(g.labels)
        state = runner.init_state(feats)
        val_nodes = g.get_validation_nodes()
        acc0 = runner.evaluate_nodes(state, feats, labels_np, val_nodes)
        for _ in range(8):
            state, _ = runner.run_epoch(state, feats, labels)
        acc1 = runner.evaluate_nodes(state, feats, labels_np, val_nodes)
        assert acc1 > max(acc0, 0.5), (acc0, acc1)

    def test_matches_host_eval_protocol(self):
        """Compiled sweep accuracy ~ host-loader eval accuracy (same model,
        both sample fixed fanouts; agreement within sampling noise)."""
        from dgll_tpu.dataloader import DataLoader
        from dgll_tpu.sampling import NeighborSampler
        from dgll_tpu.train import MiniBatchTrainer

        g, runner = self._setup()
        feats = jnp.asarray(g.node_feat)
        labels = jnp.asarray(g.labels)
        labels_np = np.asarray(g.labels)
        state = runner.init_state(feats)
        for _ in range(8):
            state, _ = runner.run_epoch(state, feats, labels)
        nodes = np.asarray(g.get_test_nodes(), np.int64)
        acc_dev = runner.evaluate_nodes(state, feats, labels_np, nodes)
        ev = MiniBatchTrainer(runner.model, runner.optimizer, seed=0)
        loader = DataLoader(g, nodes, NeighborSampler([6, 4], seed=1), 32,
                            shuffle=False, seed=1)
        pred, y = ev.predict_nodes(state, loader, feats, labels)
        acc_host = float((pred == y).mean())
        assert abs(acc_dev - acc_host) < 0.12, (acc_dev, acc_host)
