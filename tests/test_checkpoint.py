"""Device-state checkpoint: resumed render == uninterrupted render
bit-for-bit (counter-based RNG makes the comparison exact)."""
import os
import tempfile

import numpy as np

from statmc_tpu.driver import load
from statmc_tpu.testscenes import scene_text


def _scene(tmp):
    text = scene_text(width=8, height=8, spp=2, iterations=2, maxdepth=3,
                      denoise=True, filtersd=2.0, filterradius=2)
    p = os.path.join(tmp, "s.pbrt")
    open(p, "w").write(text)
    return p


def test_checkpoint_resume_bitexact():
    tmp = tempfile.mkdtemp()
    p = _scene(tmp)

    # Uninterrupted: two iterations straight through.
    r_full = load(p, base_seed=5)
    r_full.render(iterations=2, verbose=False)
    full_img = np.asarray(r_full.film_mean)
    full_states = r_full._real_states()

    # Interrupted: one iteration, checkpoint, fresh renderer, restore,
    # second iteration.
    r_a = load(p, base_seed=5)
    r_a.render(iterations=1, verbose=False)
    ck = os.path.join(tmp, "ckpt")
    r_a.save_checkpoint(ck, next_iteration=2)

    r_b = load(p, base_seed=5)
    nxt = r_b.restore_checkpoint(ck)
    assert nxt == 2
    r_b.render(iterations=2, verbose=False, start_iteration=nxt)

    np.testing.assert_array_equal(np.asarray(r_b.film_mean), full_img)
    for k, st in r_b._real_states().items():
        ref = full_states[k]
        for a, b in zip(st, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_distributed_init_single_process_noop():
    from statmc_tpu.parallel.shard import distributed_init

    devs = distributed_init()
    assert len(devs) >= 1
