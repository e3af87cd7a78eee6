"""``BENCHMARK.json`` against the rules its runner holds it to, and every
configuration, traffic mix, limit and metric found by name."""

import json
import re

import pytest

from benchmark import harness
from benchmark.reference import recipes

SPEC = json.loads(harness.SPEC.read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_top_level_keys():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                         'end_to_end', 'per_layer'}
    assert SPEC['paths'] == ['benchmark'] and 1 <= SPEC['run_seconds'] <= 51
    assert len(harness.SPEC.read_bytes()) <= 64 * 1024


@pytest.mark.parametrize('cell', [w['name'] for w in SPEC['workloads']])
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell, SPEC)
    w = c['workload']
    assert NAME.match(w['name']) and NAME.match(w['traffic']) and w['chips'] == 1
    assert 1 <= len(w['why']) <= 200
    recipes.model(c['config']['arch'])          # its plain reference beside it
    assert c['traffic']['path'] in ('sim', 'serving')
    assert set(c['limits']) >= {'weights', 'logits'}
    names = {m['name'] for m in harness.cell_metrics(SPEC, cell, False)}
    assert 'setup_s' in names and len(names) >= 2
    assert harness.cell_metrics(SPEC, cell, True)


def test_closed_loop_cell_entries_found_by_name():
    from .conftest import ONLINE
    c = harness.load_cell(ONLINE, SPEC)
    assert c['traffic']['loop'] == 'closed' and set(c['limits']) == {'weights', 'scales', 'logits'}
    e2e = {m['name'] for m in harness.cell_metrics(SPEC, ONLINE, False)}
    assert e2e == {'request_p95_ms', 'setup_s'}
    for m in harness.cell_metrics(SPEC, ONLINE, True):
        assert callable(harness.reader(m['name']).read)


@pytest.mark.parametrize('metric', [m['name'] for m in SPEC['end_to_end'] + SPEC['per_layer']])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.reader(metric).read)


def test_metric_entries():
    cells = {w['name'] for w in SPEC['workloads']}
    e2e = {m['name']: m for m in SPEC['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in SPEC['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace') and 0.01 <= m['bound'] <= 0.25
    layers = {}
    for m in SPEC['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        assert m['moves'] in e2e and set(m['workloads']) <= cells
        for cell in m['workloads']:
            assert cell in e2e[m['moves']].get('workloads', [cell])
        if m['name'].split('.')[0].endswith('_roofline') or 'mfu' in m['name']:
            assert m['unit'] == '%'
        layers.setdefault(m['layer'], set()).add(m['name'])
    assert all(1 <= len(layer) <= 200 for layer in layers)


@pytest.mark.parametrize('config', SPEC['configs'], ids=lambda c: c['name'])
def test_config_entry(config):
    assert config['file'].startswith('benchmark/') and config['reduced'] == []
    data = json.loads((harness.HERE.parent / config['file']).read_text())
    assert data['source'] == config['source'] and data['dtype'] == 'float32'
    assert data['tf32'] is False


def program_parameters(config: dict) -> list:
    """(name, shape) of every entry of the program's state dict for
    ``config``, in order: the shapes ``harness.run_cell`` draws the weights
    from, one after another from one stream."""
    from cnn_quantization_tpu_torch.models import build_model
    model, _ = build_model(config['arch'], device='meta', input_size=config['input_size'])
    return [(k, tuple(v.shape)) for k, v in model.state_dict().items()]


def same_parameters(walk_shapes: dict, config: dict) -> bool:
    """Whether a walk's ``param_shapes()`` names the program's parameters
    with their shapes in the program's order: ``harness.control_numbers``
    draws the weights in the walk's order and ``harness.run_cell`` in the
    program's, so an order of their own gives the two different weights."""
    return list(walk_shapes.items()) == program_parameters(config)


@pytest.mark.parametrize('config', SPEC['configs'], ids=lambda c: c['name'])
def test_reference_parameters_are_the_programs(config):
    data = json.loads((harness.HERE.parent / config['file']).read_text())
    assert same_parameters(recipes.model(data['arch']).param_shapes(), data)


def test_a_reordered_walk_is_caught():
    data = json.loads((harness.HERE.parent / SPEC['configs'][0]['file']).read_text())
    shapes = list(recipes.model(data['arch']).param_shapes().items())
    assert not same_parameters(dict(shapes[1:] + shapes[:1]), data)
    assert not same_parameters(dict(shapes[:-1]), data)
