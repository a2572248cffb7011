"""Pipeline parallelism (parallel/pipeline.py) on the CPU mesh: the
pipelined stack must equal sequential stage application — forward and
gradients — for both a plain MLP stage and a real transformer layer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from musicstyletransfer_tpu.parallel import make_mesh
from musicstyletransfer_tpu.parallel.pipeline import pipeline_apply


def _mlp_stage(params, h):
    return jnp.tanh(h @ params["w"] + params["b"])


def _stacked_mlp_params(n_stages, d, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": jnp.asarray(
            rng.normal(scale=0.5, size=(n_stages, d, d)).astype(np.float32)
        ),
        "b": jnp.asarray(
            rng.normal(scale=0.1, size=(n_stages, d)).astype(np.float32)
        ),
    }


def _sequential(stage_fn, stage_params, x, n_stages):
    h = x
    for i in range(n_stages):
        h = stage_fn(jax.tree.map(lambda p: p[i], stage_params), h)
    return h


class TestPipelineMLP:
    @pytest.mark.parametrize("pp,microbatches", [(2, 4), (4, 2), (4, 8)])
    def test_forward_matches_sequential(self, cpu_devices, pp, microbatches):
        mesh = make_mesh(cpu_devices[:8], tp=pp)
        d, B = 8, 8
        params = _stacked_mlp_params(pp, d)
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.normal(size=(B, d)).astype(np.float32))
        got = pipeline_apply(
            _mlp_stage, params, x, mesh=mesh, microbatches=microbatches
        )
        want = _sequential(_mlp_stage, params, x, pp)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-6)

    def test_grads_match_sequential(self, cpu_devices):
        """Backward through the pipeline (scan + ppermute transpose) is the
        mirrored pipeline; grads wrt params AND input must match."""
        pp, B, d = 4, 8, 8
        mesh = make_mesh(cpu_devices[:8], tp=pp)
        params = _stacked_mlp_params(pp, d, seed=2)
        rng = np.random.default_rng(3)
        x = jnp.asarray(rng.normal(size=(B, d)).astype(np.float32))
        w = jnp.asarray(rng.normal(size=(B, d)).astype(np.float32))

        def f_pipe(params, x):
            out = pipeline_apply(
                _mlp_stage, params, x, mesh=mesh, microbatches=4
            )
            return jnp.sum(out * w)

        def f_seq(params, x):
            return jnp.sum(_sequential(_mlp_stage, params, x, pp) * w)

        gp, gx = jax.jit(jax.grad(f_pipe, argnums=(0, 1)))(params, x)
        rp, rx = jax.grad(f_seq, argnums=(0, 1))(params, x)
        np.testing.assert_allclose(np.asarray(gx), np.asarray(rx), atol=1e-5)
        for a, b in zip(jax.tree.leaves(gp), jax.tree.leaves(rp)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-5)

    def test_rejects_bad_shapes(self, cpu_devices):
        mesh = make_mesh(cpu_devices[:8], tp=2)
        params = _stacked_mlp_params(4, 8)  # 4 stages on a 2-wide axis
        x = jnp.zeros((8, 8), jnp.float32)
        with pytest.raises(AssertionError, match="stage_params leading"):
            pipeline_apply(_mlp_stage, params, x, mesh=mesh, microbatches=4)
        with pytest.raises(AssertionError):
            pipeline_apply(
                _mlp_stage, _stacked_mlp_params(2, 8), x,
                mesh=mesh, microbatches=3,  # 8 % 3 != 0
            )


class TestTransformerPipeline:
    """The real-model adapter (parallel/transformer_pipeline.py): a
    4-layer TransformerStack — the wide encoder's depth/structure —
    pipelined as pp stages of N/pp layers, key mask riding the pipeline
    beside the activations. Forward == the sequential stack, grads ==
    sequential, and one full adam step trains identically."""

    N_LAYERS, HEADS, D, T, B = 4, 16, 64, 8, 4

    @pytest.fixture(scope="class")
    def stack(self):
        from musicstyletransfer_tpu.models.config import TransformerConfig
        from musicstyletransfer_tpu.models.transformer import (
            TransformerStack,
        )

        cfg = TransformerConfig(
            model_size=self.D, num_layers=self.N_LAYERS,
            num_heads=self.HEADS, dropout=0.0,
        )
        module = TransformerStack(config=cfg, causal=True)
        rng = np.random.default_rng(7)
        x = jnp.asarray(
            rng.normal(size=(self.B, self.T, self.D)).astype(np.float32)
        )
        # Ragged PAD suffixes: the mask must travel with its microbatch
        # through the hops for the forward to match.
        lens = np.array([self.T, self.T - 2, self.T - 5, 3])
        key_mask = jnp.asarray(
            (np.arange(self.T)[None, :] < lens[:, None]).astype(np.int32)
        )
        params = module.init(jax.random.key(0))
        return cfg, module, params, x, key_mask

    @pytest.mark.parametrize("pp,microbatches", [(2, 2), (4, 4)])
    def test_forward_matches_stack(self, cpu_devices, stack, pp,
                                   microbatches):
        from musicstyletransfer_tpu.parallel import (
            pipeline_transformer_stack,
        )

        cfg, module, params, x, key_mask = stack
        mesh = make_mesh(cpu_devices[:8], tp=pp)
        got = pipeline_transformer_stack(
            params, x, key_mask, config=cfg, causal=True, mesh=mesh,
            microbatches=microbatches,
        )
        want = module(params, x, key_mask)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-5)

    def test_grads_match_sequential(self, cpu_devices, stack):
        from musicstyletransfer_tpu.parallel import (
            pipeline_transformer_stack,
        )

        cfg, module, params, x, key_mask = stack
        mesh = make_mesh(cpu_devices[:8], tp=2)
        rng = np.random.default_rng(9)
        w = jnp.asarray(
            rng.normal(size=(self.B, self.T, self.D)).astype(np.float32)
        )

        def f_pipe(params, x):
            out = pipeline_transformer_stack(
                params, x, key_mask, config=cfg, causal=True, mesh=mesh,
                microbatches=2,
            )
            return jnp.sum(out * w)

        def f_seq(params, x):
            out = module(params, x, key_mask)
            return jnp.sum(out * w)

        gp, gx = jax.jit(jax.grad(f_pipe, argnums=(0, 1)))(params, x)
        rp, rx = jax.grad(f_seq, argnums=(0, 1))(params, x)
        np.testing.assert_allclose(np.asarray(gx), np.asarray(rx),
                                   atol=2e-4)
        flat_g = jax.tree_util.tree_leaves_with_path(gp)
        flat_r = dict(jax.tree_util.tree_leaves_with_path(rp))
        assert flat_g and len(flat_g) == len(flat_r)
        for path, leaf in flat_g:
            np.testing.assert_allclose(
                np.asarray(leaf), np.asarray(flat_r[path]), atol=2e-4,
                err_msg=str(path),
            )

    def test_trains_one_step(self, cpu_devices, stack):
        """One full optimizer step through the pipelined stack lands on
        the same parameters as through the sequential stack."""
        import optax

        from musicstyletransfer_tpu.parallel import (
            pipeline_transformer_stack,
        )

        cfg, module, params, x, key_mask = stack
        mesh = make_mesh(cpu_devices[:8], tp=2)

        def loss_pipe(p):
            out = pipeline_transformer_stack(
                p, x, key_mask, config=cfg, causal=True, mesh=mesh,
                microbatches=2,
            )
            return jnp.mean(out**2)

        def loss_seq(p):
            out = module(p, x, key_mask)
            return jnp.mean(out**2)

        tx = optax.adam(1e-3)
        opt0 = tx.init(params)

        def one_step(loss_fn):
            g = jax.grad(loss_fn)(params)
            updates, _ = tx.update(g, opt0, params)
            return optax.apply_updates(params, updates)

        new_pipe = jax.jit(lambda: one_step(loss_pipe))()
        new_seq = one_step(loss_seq)
        # adam's g/sqrt(v) normalization turns f32 reassociation noise on
        # near-zero grads into O(lr)-scale update deltas; grads themselves
        # are pinned tight in test_grads_match_sequential, so the step
        # check uses a tolerance proportional to the lr=1e-3 update scale.
        for a, b in zip(jax.tree.leaves(new_pipe), jax.tree.leaves(new_seq)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=5e-4)

    def test_rejects_uneven_split(self, cpu_devices, stack):
        from musicstyletransfer_tpu.parallel import stack_stage_params

        _, _, params, _, _ = stack
        with pytest.raises(AssertionError, match="equal stages"):
            stack_stage_params(params, 3)


class TestPipelineTransformerLayer:
    def test_transformer_stage_matches_sequential(self, cpu_devices):
        """A stack of real TransformerLayers pipelined over 2 devices equals
        running them back to back (the intended production stage_fn)."""
        from musicstyletransfer_tpu.models.config import TransformerConfig
        from musicstyletransfer_tpu.models.transformer import TransformerLayer

        pp, B, T, d = 2, 4, 6, 16
        mesh = make_mesh(cpu_devices[:8], tp=pp)
        cfg = TransformerConfig(model_size=d, num_layers=1, num_heads=2,
                                dropout=0.0)
        layer = TransformerLayer(config=cfg, causal=False)
        rng = np.random.default_rng(4)
        x = jnp.asarray(rng.normal(size=(B, T, d)).astype(np.float32))

        def stage_fn(params, h):
            # The pipeline passes activations only; the mask is derived per
            # microbatch (all-valid here — masking itself is pinned by the
            # attention tests).
            key_mask = jnp.ones(h.shape[:2], jnp.int32)
            return layer(params, h, key_mask)

        init_mask = jnp.ones((B, T), jnp.int32)
        p0 = layer.init(jax.random.key(0))
        p1 = layer.init(jax.random.key(1))
        stacked = jax.tree.map(
            lambda a, b: jnp.stack([a, b]), p0, p1
        )

        got = pipeline_apply(
            stage_fn, stacked, x, mesh=mesh, microbatches=2
        )
        want = stage_fn(p1, stage_fn(p0, x))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-5)
