"""BAT's two cells, pinned when BAT moved behind models/bat.py: on the
tiny root at seed 7 and one host thread (as run.py runs), the SHA-256 of
every input tensor (weights, pose noise, images), the program's and the
reference's losses over the compared steps, and the numbers compared, all
recorded before the move.  The pin covers the cells in ``PINNED`` alone;
a cell added later is held by the tests every cell joins, not here."""
import hashlib
import time

import pytest
import torch

from benchmark import harness, judge, program, spec
from benchmark.tests.tiny import ROOT

SEED = 7
PINNED = {
    'bat_blender.masked': {
        'sha256': {
            'weights.density_planes.0':
            'dbcade21ff7b16eb5cb09c727de50a439f0fa9b8d23005dbfb809a1484454ef2',
            'weights.density_planes.1':
            '88ab8ec055ab7d518bff7f2295db4a50f9807e0e37cd1ace67f774e5ff0b3269',
            'weights.density_planes.2':
            'a2819c4bd57df87214a99045e0b7940f6df33cb54a2f3e0388a02d81f2056fdb',
            'weights.density_lines.0':
            '344bb2dbe5960e4b9edca77c886b120faaa4eeece59100e422dc38ec68367997',
            'weights.density_lines.1':
            'b7696a26e9d5ab06fcbb7bd0f7e437d05557050d3be904dca7d401ff10d65a70',
            'weights.density_lines.2':
            'd5b80c11e8d7a969a1fb9c40cd08b4315bd8d777ce4fb0fcee4ff93420f54609',
            'weights.app_planes.0':
            'bcc4d447d4af13b758d69cca70deb3787bbcccbb3e19e18275c947d90f8a419d',
            'weights.app_planes.1':
            '00eaba9bf6af64c3e8742cf3cef3e105e03a3955831254c50c982fe0a2763440',
            'weights.app_planes.2':
            '88a9ce420edfdfc55279a4634d803cc2550d104f96603ee2f18ec1446aff56ea',
            'weights.app_lines.0':
            'e3b56e2787b3c539ecd904f48a875c40fb615441941673654637d01e8b36314c',
            'weights.app_lines.1':
            'bb888ab87e0c6b6fb2cfb429131bd816b0988a21bbd1f4a7eeb1bf4f8401b120',
            'weights.app_lines.2':
            'b3bcf020aee8c942f5333a5732a69d06636b3344fe99e4efd2ce912bf795ce5e',
            'weights.basis':
            '0e64ac22764ea2db072600a53116ff5ff430885db19304fc50c68b20d4a202a5',
            'weights.shading.layers.0.w':
            'cc9167de8fcfe581a8c87af91b7de7b2ba97c4b2fbf0c740d04ac461f18d0f6d',
            'weights.shading.layers.0.b':
            '870717f8dda62adf2687b9a7e15181ad866b6bf56b8dea4318998424a605265d',
            'weights.shading.layers.1.w':
            'c29176a7d1070f6e9a203c48c0553ccfc97b598d3b8057597d69be4d3b2fe4d7',
            'weights.shading.layers.1.b':
            'a3fafd7fcbadd775e396cb0f14a5ea5140fa1061975b4a0d9494f0892408fc23',
            'weights.shading.layers.2.w':
            '30703b6c0d110ba65e5077258b65fed6b08c240c17d310522fb7f09941825cd0',
            'weights.shading.layers.2.b':
            'deaa000e0616b3eb7736a3984e9a00b8565fac170618bc1fa838397cfcb80ef6',
            'images':
            'a285ed253c2dfd0485b831b5638d5c8bc53534a0d4856b8ceb06c03d6048e7f6',
            'noise_se3':
            '93a6c9424ff5680a91ae5803905e7b6e92932085201e79cd8a87d9609755cd7b',
        },
        'program_losses': [
            0.028075650334358215, 0.03351675719022751,
            0.0320948101580143],
        'reference_losses': [
            0.028075650334358215, 0.03351676091551781,
            0.0320948101580143],
        'checks': {
            'loss_gap': 0.0,
            'grad_gap': 3.474342636365936e-06,
            'change_gap': 1.6142258495670646e-06,
        },
    },
    'bat_llff.final': {
        'sha256': {
            'weights.density_planes.0':
            '4b2df07e393641b7e608eaafdb4c412b1c66a8b940b218316ba9790ab6ce5c76',
            'weights.density_planes.1':
            'f7d87811e266465248e745c1dd1eb254c86433ddd54848ad0b935f20c92a3253',
            'weights.density_planes.2':
            '1252169d96c26552bd2cb8f9f62dd42c09bd2ad75d23cf3d304f4cfc20c2baa3',
            'weights.density_lines.0':
            'c541b403c08f8fb2c87b7f1550e133017013eae3c279fc936a2f4a8fc3551dcc',
            'weights.density_lines.1':
            '2a16badeb51543d380978b1673e750ad88bbd9397407da1416dd5dc8b81fded4',
            'weights.density_lines.2':
            '7703b72852d3e1f27029203c3da2def58b9fa25a6dec21c00906f7744f37b1d5',
            'weights.app_planes.0':
            '21bef309c3bf4c05c9dd307d34b21a521dd20d6099cc533f951f2252b3c41c12',
            'weights.app_planes.1':
            '69dcd56f00168b3bcc5a45624d2778fe8ee843c58863a71747af6dd437fb1481',
            'weights.app_planes.2':
            '93da31e5d4bfa93cb6c2d70fe1ac02945ea8f0813de3bcfd9fedabc615b7ea90',
            'weights.app_lines.0':
            'c198daeddc10e0849842542b741d1b0b917c75a151ac18c64445d46a36cf4369',
            'weights.app_lines.1':
            '6277c50e6ecd6b11893220277daef4b21afb3cbc1fd0c6b26b645a81483feac5',
            'weights.app_lines.2':
            'fba9e58564895935e281e9c92739fc03279d1248bd9a57d66fa7f2d491da2635',
            'weights.basis':
            '17b611929cb6bbf3b84aac1d4423be8288cdbb59f379e92f6118170e43931907',
            'weights.shading.layer1.w':
            '0fbf3cff28daeb0de277124e343eddcf67f97d2242c3ed114acad08c73aaca55',
            'weights.shading.layer1.b':
            'be6be32ddd8bef1f9e931b2c6a90ce261cc64b454feab744ba02a85af8078740',
            'weights.shading.layer2.w':
            'f422df16aba86d1d1920adfc2f2fccbf13968d57283a7e76f4a9d879ba9eb673',
            'weights.shading.layer2.b':
            '4f252080c4f1c987e8f6e2d1faf765c286f2b0dcc34ecb02dd7211cddc21d698',
            'weights.shading.layer3.w':
            '9921cd7d6cbad6f00d1f6be1919abecbbd35acc82afbef32a0fcc8e9ca1ae0e4',
            'weights.shading.layer3.b':
            '4e9a4a9fac3b659c33ff745339a788c139d579f1a861052c2ad3f59cde069d0d',
            'images':
            '6712fe295d9740fd1416067df7d9ca702bb5541bc0e2dd68dd5f087b2cb0cecb',
        },
        'program_losses': [
            0.15416011214256287, 0.11869604140520096,
            0.15115047991275787],
        'reference_losses': [
            0.15416012704372406, 0.11869603395462036,
            0.15115045011043549],
        'checks': {
            'loss_gap': 9.66602809663051e-08,
            'change_gap': 8.2497178596492e-05,
        },
    },
}


def _sha256(t) -> str:
    return hashlib.sha256(
        t.detach().to("cpu").contiguous().numpy().tobytes()).hexdigest()


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_every_pinned_name_is_a_cell():
    assert sorted(set(PINNED) - set(spec.cells(ROOT))) == []


@pytest.mark.parametrize("name", sorted(PINNED))
def test_bat_inputs_and_first_steps_are_pinned(tiny_root, one_thread, name):
    cpu = torch.device("cpu")
    cell = spec.cell(tiny_root, name)
    model, opts = cell.model, cell.config["options"]
    n = int(cell.traffic["check_steps"])
    x = model.make_inputs(opts, SEED, cell.start_it, cpu,
                          warm_radii=float(cell.config["warm_radii"]))
    got = {f"weights.{k}": _sha256(v) for k, v in x.weights.items()}
    got["images"] = _sha256(x.images)
    if x.noise_se3 is not None:
        got["noise_se3"] = _sha256(x.noise_se3)
    want = PINNED[name]
    assert got == want["sha256"]
    prog = program.first_steps(model, model.build(x, cpu), n,
                               int(opts["freq"]["scalar"]))
    assert prog["losses"] == want["program_losses"]
    ref = model.Reference(x, cpu).run(n)
    assert ref["losses"] == want["reference_losses"]
    # the numbers compared before the move, now the judge's readings
    read = judge.readings(prog, ref)
    assert {k: read[k] for k in want["checks"]} == want["checks"]
    r = harness.run(tiny_root, name, SEED, 0.2, False, time.perf_counter(),
                    device="cpu")
    assert r["correct"], r["checks"]
