"""One rank of the port's sharded evaluation on the CPU (gloo), and the same
scenarios on one process.

Launched by tests/test_torch_parallel.py as

    python tests/_torch_parallel_worker.py <init_method> <world> <rank> <data> <model> <out.npz>

Every rank builds the same seeded ResNet-18 at 64x64 (the JAX package's
tests/test_parallel.py set-up), runs ``scenarios`` on a (data, model) mesh
of the gloo process group and rank 0 writes the results.  The test runs
``scenarios`` on one process (no process group, the 1x1 mesh) for the
reference.  With a seventh argument ``checkpoint`` (tests/test_torch_
checkpoint_sharded.py) every rank instead saves its shard of the W8A8
serving tree (``serving_tree``) into the DCP directory <out> and checks that
its slices read back equal.  Imports nothing of the JAX package.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cnn_quantization_tpu_torch.calib.calibrator import collect_statistics  # noqa: E402
from cnn_quantization_tpu_torch.engine import QuantEngine, QuantPolicy  # noqa: E402
from cnn_quantization_tpu_torch.models import build_model  # noqa: E402
from cnn_quantization_tpu_torch.parallel import make_mesh, shard_params  # noqa: E402
from cnn_quantization_tpu_torch.parallel.eval_parallel import make_sharded_eval_step  # noqa: E402
from cnn_quantization_tpu_torch.parallel.mesh import shard_batch  # noqa: E402

ARCH, SIZE, BATCH = 'resnet18', 64, 8
HEADLINE = dict(qtype='int4', qweight='int4', pcq_weights=True, pcq_act=True,
                clipping='laplace', bit_alloc_act=True, bit_alloc_weight=True,
                bias_corr_weight=True)


def images(seed, n=BATCH):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, SIZE, SIZE, 3).astype(np.float32),
            rng.randint(0, 1000, n).astype(np.int32))


def scenarios(mesh):
    """Results of every scenario on ``mesh``: name -> dict of numpy values."""
    torch.set_num_threads(1)
    model, meta = build_model(ARCH, device='cpu', seed=0, input_size=SIZE)
    params = dict(model.state_dict())
    eng = QuantEngine(model, QuantPolicy(arch=ARCH, **HEADLINE), meta)
    pq = eng.quantize_params(params)
    out = {}

    def stats_of(seed):
        return collect_statistics(eng.make_collect(), pq, [images(seed)])

    def frozen():
        qp = eng.freeze_qparams(stats_of(7), input_shape=(BATCH, SIZE, SIZE, 3))
        return sharded(eng, pq, mesh, images(0), qparams=qp)

    def use_stats():
        st = stats_of(8)
        return sharded(eng, pq, mesh, images(0), stats=st)

    def dynamic():
        return sharded(eng, pq, mesh, images(0))

    def collect():
        x, y = images(11)
        fn = eng.make_collect(mesh=mesh if mesh.data > 1 else None)
        _, st = fn(pq, shard_batch(mesh, x, y)[0])
        return {f'{site}/{k}': v.numpy() for site, entry in st.items() for k, v in entry.items()}

    def serving():
        w8 = QuantEngine(model, QuantPolicy(arch=ARCH, qtype='int8', qweight='int8'), meta)
        sp = w8.prepare_serving_params(w8.quantize_params(params))
        scales = w8.freeze_serving_scales(sp, [images(5, 4)])
        return sharded(w8, sp, mesh, images(6, 4), quantized='serving_int8', act_scales=scales)

    for name, fn in (('frozen', frozen), ('use_stats', use_stats), ('dynamic', dynamic),
                     ('collect', collect), ('serving', serving)):
        out[name] = fn()
    return out


def sharded(eng, params, mesh, batch, *, quantized=True, stats=None, qparams=None,
            act_scales=None):
    from cnn_quantization_tpu_torch.calib.calibrator import stats_to_device
    from cnn_quantization_tpu_torch.parallel.eval_parallel import gather_batch
    x, y = batch
    step = make_sharded_eval_step(eng, mesh, quantized, qparams=qparams, act_scales=act_scales)
    out = step(shard_params(params, mesh, eng.model), stats_to_device(stats, eng.device),
               *shard_batch(mesh, x, y))
    return {'top1': float(out['top1']), 'top5': float(out['top5']), 'loss': float(out['loss']),
            'logits': gather_batch(out['logits'], mesh).numpy()}


def serving_tree():
    """(model, W8A8 serving params) of the seeded ResNet-18 at 64x64: int8
    codes (4-D in channels_last memory), float32 scales and the float stem."""
    model, meta = build_model(ARCH, device='cpu', seed=0, input_size=SIZE)
    eng = QuantEngine(model, QuantPolicy(arch=ARCH, qtype='int8', qweight='int8'), meta)
    return model, eng.prepare_serving_params(eng.quantize_params(dict(model.state_dict())))


def save_shard(mesh, path):
    from chip_smoke import same_tree
    from cnn_quantization_tpu_torch.utils.checkpoint import (load_params_sharded,
                                                             save_params_sharded)
    torch.set_num_threads(1)
    model, sp = serving_tree()
    mine = shard_params(sp, mesh, model)
    save_params_sharded(path, mine, mesh, model)
    if not same_tree(load_params_sharded(path, mesh, model, device='cpu'), mine):
        raise AssertionError(f'rank {mesh.model_index}: its slices read back differ')


def main():
    import torch.distributed as dist
    from cnn_quantization_tpu_torch.parallel.distributed import init_distributed
    init_method, world, rank, data, model, out_path = sys.argv[1:7]
    assert init_distributed(init_method, int(world), int(rank), backend='gloo')
    mesh = make_mesh(data=int(data), model=int(model))
    if sys.argv[7:] == ['checkpoint']:
        save_shard(mesh, out_path)
        dist.destroy_process_group()
        return
    results = scenarios(mesh)
    if dist.get_rank() == 0:
        np.savez(out_path, **{f'{name}|{k}': np.asarray(v) for name, entry in results.items()
                              for k, v in entry.items()})
    dist.barrier()
    dist.destroy_process_group()


if __name__ == '__main__':
    main()
