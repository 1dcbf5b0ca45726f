"""Browser UI for unsupervised segmentation (port of the JAX package's
``apps/webapp_segmentation.py``).  The reference ships a Streamlit page
(``streamlit-app.py:41-47``); this is the same interaction (pick a bundled
image, tune superpixel/GC knobs, view the model estimate + GraphCut result
sheet) served by the standard-library ``http.server``, with the
segmentation on ``--device``.

Run::

    python -m pyimsegm_tpu_torch.apps.webapp_segmentation --port 8701

then open http://localhost:8701 .
"""

import argparse
import base64
import glob
import html
import io
import logging
import os
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from pyimsegm_tpu_torch.apps import common
from pyimsegm_tpu_torch.utils.data_samples import PATH_DATA_IMAGES as DATA

#: the streamlit page's feature set (color stats + short LM texture bank)
FEATURES_SET_MIN = {'color': ('mean', 'std'), 'tLM_short': ('mean',)}

PAGE = """<!doctype html><html><head><title>pyimsegm-tpu demo</title>
<style>
 body {{ font-family: sans-serif; margin: 2em; max-width: 1100px; }}
 label {{ display: inline-block; width: 11em; }}
 fieldset {{ border: 1px solid #bbb; margin-bottom: 1em; }}
 img {{ max-width: 100%; }}
 .err {{ color: #b00; white-space: pre-wrap; }}
</style></head><body>
<h2>Unsupervised superpixel segmentation</h2>
<form method="get" action="/">
<fieldset><legend>input</legend>
<label>image</label><select name="image">{options}</select>
</fieldset>
<fieldset><legend>parameters</legend>
<label>classes</label><input name="nb_classes" value="{nb_classes}" size="4"><br>
<label>superpixel size</label><input name="sp_size" value="{sp_size}" size="4"><br>
<label>superpixel regul.</label><input name="sp_regul" value="{sp_regul}" size="4"><br>
<label>GraphCut regul.</label><input name="gc_regul" value="{gc_regul}" size="4">
</fieldset>
<button type="submit">segment</button>
</form>
{body}
</body></html>"""


def _bundled_images():
    pats = ['drosophila_disc/image/*.jpg', 'drosophila_ovary_slice/image/*.jpg',
            'langerhans_islets/image/*.jpg', 'histology_CIMA/*.jpg']
    paths = []
    for pat in pats:
        paths += sorted(glob.glob(os.path.join(DATA, pat)))
    return paths


def _png_b64(fig):
    import matplotlib.pyplot as plt
    buf = io.BytesIO()
    fig.savefig(buf, format='png', dpi=80, bbox_inches='tight')
    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode('ascii')


def run_segmentation(path_img, nb_classes, sp_size, sp_regul, gc_regul,
                     device='cuda'):
    """The streamlit page's compute chain: group-model estimate + GC segment
    with debug visuals (``streamlit-app.py:41-47``), on ``device``."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    import numpy as np
    from PIL import Image

    from pyimsegm_tpu_torch import pipelines
    from pyimsegm_tpu_torch.utils import drawing

    img = np.asarray(Image.open(path_img))
    model, _ = pipelines.estim_model_classes_group(
        [img], nb_classes, FEATURES_SET_MIN,
        sp_size=sp_size, sp_regul=sp_regul, device=device)
    debug = {}
    segm, _soft = pipelines.segment_color2d_slic_features_model_graphcut(
        img, model, FEATURES_SET_MIN, sp_size=sp_size, sp_regul=sp_regul,
        gc_regul=gc_regul, debug_visual=debug)
    segm = np.asarray(segm)

    figs = []
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(img)
    ax.contour(np.asarray(debug['slic']), colors='r', linewidths=0.4)
    ax.set_title('superpixel contours')
    ax.axis('off')
    figs.append(('superpixels', fig))
    fig = drawing.figure_image_segm_results(img, segm)
    figs.append(('segmentation', fig))
    return [(name, _png_b64(f)) for name, f in figs]


class Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):
        logging.info('%s ' + fmt, self.client_address[0], *args)

    def do_GET(self):
        q = parse_qs(urlparse(self.path).query)
        images = _bundled_images()
        sel = q.get('image', [''])[0]
        params = dict(
            nb_classes=int(q.get('nb_classes', ['3'])[0]),
            sp_size=int(q.get('sp_size', ['30'])[0]),
            sp_regul=float(q.get('sp_regul', ['0.5'])[0]),
            gc_regul=float(q.get('gc_regul', ['0.4'])[0]))
        body = ''
        if sel:
            if sel not in images:  # only bundled images are servable
                body = '<p class="err">unknown image</p>'
            else:
                try:
                    figs = run_segmentation(sel, device=self.server.device,
                                            **params)
                    body = ''.join(
                        '<h3>%s</h3><img src="data:image/png;base64,%s">'
                        % (html.escape(n), b) for n, b in figs)
                except Exception:
                    body = ('<p class="err">%s</p>'
                            % html.escape(traceback.format_exc()))
        options = ''.join(
            '<option value="%s"%s>%s</option>'
            % (html.escape(p, quote=True),
               ' selected' if p == sel else '',
               html.escape(os.path.relpath(p, DATA)))
            for p in images)
        page = PAGE.format(options=options, body=body, **params)
        data = page.encode()
        self.send_response(200)
        self.send_header('Content-Type', 'text/html; charset=utf-8')
        self.send_header('Content-Length', str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--port', type=int, default=8701)
    parser.add_argument('--host', default='127.0.0.1')
    common.add_device_arg(parser)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    srv = ThreadingHTTPServer((args.host, args.port), Handler)
    srv.device = args.device
    logging.info('serving on http://%s:%i', args.host, args.port)
    srv.serve_forever()


if __name__ == '__main__':
    main()
