"""Driver of ``segment_color2d_slic_features_model_graphcut`` with a
trained forest (BASELINE config 2)."""

import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Driver:
    def __init__(self, config, device):
        self.config, self.device = config, device
        self.forest = None
        self.clf = None

    def setup(self):
        """Load the forest (an input, like weights) and hand it to the
        port as a fitted classifier on the device."""
        from pyimsegm_tpu_torch import classification
        with np.load(os.path.join(ROOT, self.config['forest_file'])) as f:
            self.forest = {k: f[k] for k in f.files}
        self.clf = classification.classifier_from_numpy(
            self.forest, self.config['classifier'], device=self.device)

    def _run(self, item, debug):
        from pyimsegm_tpu_torch import pipelines
        c = self.config
        return pipelines.segment_color2d_slic_features_model_graphcut(
            item, self.clf, c['dict_features'], sp_size=c['sp_size'],
            sp_regul=c['sp_regul'], gc_regul=c['gc_regul'],
            gc_edge_type=c['gc_edge_type'], debug_visual=debug)

    def call(self, item):
        return self._run(item, None)

    def capture(self, item):
        debug = {}
        segm, soft = self._run(item, debug)
        return {'segm': segm, 'soft': soft,
                'labels': debug['slic'].astype(np.int64),
                'features': debug['features'], 'proba': debug['proba']}

    def judge(self, item, outputs):
        """Numbers of a capture's outputs against the reference."""
        from portbench.reference import sup2d
        return sup2d.judge(item, outputs, self.forest, self.config,
                           self.device)

    def control(self, item, mode=None):
        """The reference's outputs in the configuration's control
        precision (or ``mode``), in the place of a capture's."""
        from portbench.reference import sup2d
        return sup2d.pipeline(item, self.forest, self.config, self.device,
                              mode or self.config['control'])
