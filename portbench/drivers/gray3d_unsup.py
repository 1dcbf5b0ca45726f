"""Driver of ``pipe_gray3d_slic_features_model_graphcut``: unsupervised
segmentation of a gray volume, the class model fitted on each volume."""

from portbench.reference.gray3d import MODEL_ARRAYS


class Driver:
    def __init__(self, config, device):
        self.config, self.device = config, device

    def setup(self):
        """Nothing to make: the model is fitted on each volume."""

    def _run(self, item, debug):
        from pyimsegm_tpu_torch import pipelines
        c = self.config
        return pipelines.pipe_gray3d_slic_features_model_graphcut(
            item, c['nb_classes'], c['dict_features'],
            spacing=tuple(c['spacing']), sp_size=c['sp_size'],
            sp_regul=c['sp_regul'], gc_regul=c['gc_regul'],
            estim_model=c['estim_model'], device=self.device,
            debug_visual=debug)

    def call(self, item):
        return self._run(item, None)

    def capture(self, item):
        debug = {}
        segm = self._run(item, debug)
        model = debug['model']
        return {'segm': segm, 'labels': debug['slic'],
                'features': debug['features'],
                'model': {n: getattr(model, n).cpu().numpy()
                          for n in MODEL_ARRAYS}}

    def judge(self, item, outputs):
        """Numbers of a capture's outputs against the reference."""
        from portbench.reference import gray3d
        return gray3d.judge(item, outputs, self.config, self.device)

    def control(self, item, mode=None):
        """The reference's outputs in the configuration's control
        precision (or ``mode``), in the place of a capture's."""
        from portbench.reference import gray3d
        return gray3d.pipeline(item, self.config, self.device,
                               mode or self.config['control'])
