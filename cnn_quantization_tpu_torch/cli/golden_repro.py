"""One-command golden-number reproduction runbook.

Port of ``cnn_quantization_tpu/cli/golden_repro.py``: sweeps the reference's
six published golden configurations (reference README.md:50-141, mirrored
in BASELINE.md) through the port's CLI in process and prints a comparison
table: measured top-1/top-5 beside the reference's published numbers and a
PASS/FAIL verdict at the reference's own +-0.5 variance band (README.md:49),
held on top-1 AND top-5 (the JAX runbook checks top-1 only, :120).  The day
a checkpoint and ImageNet are on a machine, reference parity is:

    python -m cnn_quantization_tpu_torch.cli.golden_repro \
        --data /path/to/ILSVRC2012 --resnet50 r50.pth --vgg16 vgg16.pth

(``--data`` takes the preprocessed ``.npz`` as well; a class-folder tree
needs PIL.)  Without data or weights the sweep still runs end to end on
synthetic batches (``--smoke`` shrinks it to seconds): every config runs its
whole pipeline, collect -> use round trips included, with no verdict.
Unlike the JAX runbook, ``--input_size`` applies to VGG too: the port builds
VGG's first classifier for the input size.  ``--device cpu`` runs on the CPU
(default: the card).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys

# (name, arch, expected top-1, expected top-5, argv builder)
# Flags are the reference's own commands, verbatim where they exist.
GOLDEN = [
    ('w4a4_naive', 'resnet50', 62.154, 84.252, lambda a: [
        '-a', 'resnet50', '-pcq_w', '-pcq_a', '-sh',
        '--qtype', 'int4', '-qw', 'int4']),
    ('w4a4_headline', 'resnet50', 73.330, 91.334, lambda a: [
        '-a', 'resnet50', '-pcq_w', '-pcq_a', '-sh',
        '--qtype', 'int4', '-qw', 'int4', '-c', 'laplace',
        '-baa', '-baw', '-bcw']),
    # two-phase: collect 32-image stats at int8, then evaluate W4A4 -sm use
    ('w4a4_headline_offline_stats', 'resnet50', 74.2, 91.932, lambda a: [
        '-a', 'resnet50', '-pcq_w', '-pcq_a',
        '--qtype', 'int4', '-qw', 'int4', '-c', 'laplace',
        '-baa', '-baw', '-bcw', '-sm', 'use']),
    ('int4_2std', 'resnet50', 15.440, 34.646, lambda a: [
        '-a', 'resnet50', '-pcq_w', '-pcq_a', '-sh',
        '--qtype', 'int4', '-c', '2std']),
    ('int4_aciq_layerwise', 'resnet50', 71.404, 90.248, lambda a: [
        '-a', 'resnet50', '--qtype', 'int4', '-c', 'laplace', '-sm', 'use']),
    ('vgg16_midtread_entropy', 'vgg16', 70.801, 91.211, lambda a: [
        '-a', 'vgg16', '-b', '32', '-pcq_w', '-pcq_a', '-sh',
        '--qtype', 'int4', '-qw', 'int4', '-c', 'laplace', '-baa', '-baw',
        '-bcw', '-bata', '5.3', '-batw', '5.3', '-mtq', '-me',
        '-ss', str(a.subset or 1024)]),
]

# configs that need an offline-statistics artifact first (reference:
# collect at int8 on 32 images, inference_sim.py -sm collect -ac -cs 32)
NEEDS_STATS = {'w4a4_headline_offline_stats': ('-pcq_a',),
               'int4_aciq_layerwise': ()}


def _run_cli(argv):
    """The port's inference CLI in process: (result JSON, real_data);
    real_data is False when the CLI fell back to synthetic batches (no
    verdict may be asserted on those numbers)."""
    from .inference_sim import main
    buf, outer = io.StringIO(), sys.stdout

    class Tee(io.TextIOBase):
        def write(self, s):
            buf.write(s)
            return outer.write(s)

    with contextlib.redirect_stdout(Tee()):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f'CLI failed ({rc}) for {argv}')
    text = buf.getvalue()
    real_data = 'using synthetic data' not in text
    for line in reversed(text.strip().splitlines()):
        line = line.strip()
        if line.startswith('{'):
            return json.loads(line), real_data
    return {}, real_data


def verdict(got1: float, got5: float, want1: float, want5: float, tol: float) -> str:
    """PASS when top-1 AND top-5 are each within ``tol`` of the reference's."""
    return 'PASS' if abs(got1 - want1) <= tol and abs(got5 - want5) <= tol else 'FAIL'


def run_sweep(args):
    rows = []
    for name, arch, want1, want5, build in GOLDEN:
        if args.only and name not in args.only:
            continue
        common = ['--data', args.data, '-b', str(args.batch)]
        if args.device:
            common += ['--device', args.device]
        if args.input_size:
            common += ['--input_size', str(args.input_size)]
        if args.subset:
            common += ['-ss', str(args.subset)]
        weights = getattr(args, arch.replace('-', '_'), None)
        if weights:
            common += ['-w', weights]
        if name in NEEDS_STATS:
            # phase 1: the reference's 32-image int8 collect pass.  Config
            # flags come AFTER the common ones so the batch-1 protocol
            # (and vgg's verbatim '-b 32') survive argparse's last-wins.
            collect = common + ['-a', arch, '-b', '1', '--qtype', 'int8',
                                '-sm', 'collect', '-ac', '-cs',
                                str(args.cal_set_size)] + list(NEEDS_STATS[name])
            _run_cli(collect)
        res, real_data = _run_cli(common + build(args))
        got1 = res.get('top1', float('nan'))
        got5 = res.get('top5', float('nan'))
        if bool(weights) and real_data and not args.smoke:
            v = verdict(got1, got5, want1, want5, args.tol)
        elif weights and not real_data and not args.smoke:
            v = 'ran (ImageNet NOT FOUND at --data; synthetic fallback, no verdict)'
        else:
            v = 'ran (synthetic/smoke: accuracy not meaningful)'
        rows.append({'config': name, 'arch': arch, 'top1': got1, 'top5': got5,
                     'ref_top1': want1, 'ref_top5': want5, 'verdict': v,
                     **({'avg_entropy': res['avg_entropy']} if 'avg_entropy' in res else {})})
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--data', default='~/datasets/ILSVRC2012')
    p.add_argument('--resnet50', default=None,
                   help='resnet50 checkpoint (.pth state dict or .npz)')
    p.add_argument('--vgg16', default=None, help='vgg16 checkpoint')
    p.add_argument('-b', '--batch', type=int, default=512)
    p.add_argument('--subset', '-ss', type=int, default=None)
    p.add_argument('--input_size', type=int, default=None)
    p.add_argument('--cal_set_size', type=int, default=32)
    p.add_argument('--device', default=None, help='cuda (default) or cpu')
    p.add_argument('--tol', type=float, default=0.5,
                   help='top-1 and top-5 tolerance (reference README.md:49: +-0.5)')
    p.add_argument('--only', nargs='*', default=None,
                   help='subset of config names to run')
    p.add_argument('--smoke', action='store_true',
                   help='pipeline smoke: tiny batch/subset/input, synthetic '
                        'data OK, verdicts not asserted')
    p.add_argument('--out', default=None, help='write rows as JSON here')
    args = p.parse_args(argv)
    if args.smoke:
        args.batch = min(args.batch, 2)
        args.subset = args.subset or 4
        args.input_size = args.input_size or 64
        args.cal_set_size = 2

    rows = run_sweep(args)
    if not rows:
        names = ', '.join(n for n, *_ in GOLDEN)
        print(f'no configs matched --only {args.only}; known: {names}')
        return 2
    w = max(len(r['config']) for r in rows) + 2
    print('\n=== golden-number comparison (reference README.md:50-141) ===')
    print(f'{"config":{w}s} {"top1":>8s} {"ref":>8s} {"top5":>8s} '
          f'{"ref":>8s}  verdict')
    for r in rows:
        print(f'{r["config"]:{w}s} {r["top1"]:8.3f} {r["ref_top1"]:8.3f} '
              f'{r["top5"]:8.3f} {r["ref_top5"]:8.3f}  {r["verdict"]}')
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(rows, f, indent=1)
        print(f'-> {args.out}')
    return 1 if any(r['verdict'] == 'FAIL' for r in rows) else 0


if __name__ == '__main__':
    sys.exit(main())
