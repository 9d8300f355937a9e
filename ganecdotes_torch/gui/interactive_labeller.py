"""Interactive on-the-fly segmentation (port of
ganecdotes_tpu/gui/interactive_labeller.py).

The labelling canvas beside a live 4-column grid of (generated image,
predicted mask) pairs, with the buttons Regenerate (new latents),
Update/Train (the pipeline's train block on the painted mask) and Save (a
PNG of the window and the grid's latents).

``InteractiveSession`` is the learner half without any window: the painter
(``MaskPainter``) and the actions ``get_test_image_output``,
``update_or_train``, ``regenerate`` and ``save``. It imports neither
matplotlib nor cv2 (cv2 only rasterises a polygon or a stroke when one is
painted), so it runs on a machine that has neither. ``InteractiveLabellerGUI``
binds the widgets to those actions.

A grid refresh is one batched request through the pipeline's server
(``OneShotPipeline._make_infer_fn``, cached until the next Update/Train),
assembled on the device and copied to the host once.
"""

import os
import time

import numpy as np
import torch

from ganecdotes_torch.gui.labeller import MaskPainter, OneShotLabellerGUI
from ganecdotes_torch.models.stylegan2.generator import mapping_apply


class InteractiveSession(MaskPainter):
    """The painter over the one-shot image of ``one_shot_learner`` (a
    ``OneShotPipeline`` after its setup block), and the grid of its first
    ``num_outs`` (at most 8) test latents."""

    def __init__(self, one_shot_learner):
        learner = one_shot_learner
        self.one_shot_learner = learner
        self.num_outs = min(8, len(learner.test_latents))
        self.out_latents = np.asarray(learner.test_latents[: self.num_outs])
        self.snap_dir = os.path.join(learner.out_dir, "snaps")
        os.makedirs(self.snap_dir, exist_ok=True)
        self._infer_cache = None
        MaskPainter.__init__(
            self, learner.transform_im_for_gui(learner.one_shot_img),
            learner.model_config.classes)
        self.out_grid = self.get_test_image_output(with_labels=False)

    # -- output grid ---------------------------------------------------

    def get_test_image_output(self, with_labels=True):
        """The (rows * H, 4 * W, 3) float32 grid of (image in [0, 1], mask
        colours) pairs: the server's request once the head is trained
        (``with_labels``), else the images alone beside black masks."""
        learner = self.one_shot_learner
        latents = torch.as_tensor(self.out_latents)
        if with_labels and learner.segmentor_params is not None:
            if self._infer_cache is None:
                self._infer_cache = learner._make_infer_fn()
            imgs, preds = self._infer_cache(latents)[:2]
        else:
            imgs, preds = learner.get_image_from_latent(latents), None
        return self._grid(imgs, preds, learner.color_map)

    def _grid(self, imgs, preds, color_map):
        n = self.num_outs
        ims = imgs[:n].float().clamp(-1, 1) * 0.5 + 0.5  # exact for bf16 images
        if preds is None:
            masks = torch.zeros_like(ims)
        else:  # visualize_label_mask: classes 1..len - 1 coloured, others black
            cm = torch.as_tensor(np.asarray(color_map, np.float32),
                                 device=ims.device)
            p = preds[:n]
            shown = (p > 0) & (p < len(cm))
            masks = torch.where(shown[..., None], cm[p.clamp(0, len(cm) - 1)],
                                torch.zeros((), device=ims.device))
        _, h, w, c = ims.shape
        tiles = torch.stack([ims, masks], dim=1).reshape(2 * n, h, w, c)
        rows = (2 * n + 3) // 4
        tiles = torch.cat([tiles, tiles.new_zeros(rows * 4 - 2 * n, h, w, c)])
        grid = tiles.reshape(rows, 4, h, w, c).permute(0, 2, 1, 3, 4)
        return grid.reshape(rows * h, 4 * w, c).cpu().numpy()

    def refresh_grid(self, with_labels=True):
        self.out_grid = self.get_test_image_output(with_labels=with_labels)
        return self.out_grid

    # -- actions -------------------------------------------------------

    def update_or_train(self):
        """The pipeline's train block on the painted labels, then a grid
        refresh through the retrained head."""
        learner = self.one_shot_learner
        learner.one_shot_label = torch.as_tensor(
            self.get_labels().astype(np.int64), device=learner.device)
        learner.run_pipeline(blocks_to_run=["train"])
        self._infer_cache = None  # the server holds the old head
        return self.refresh_grid(with_labels=True)

    def regenerate(self, z=None):
        """New grid latents: w = mapping(z), for ``z`` (num_outs,
        latent_dim) given, else drawn from a generator seeded with the
        pipeline's seed and the clock's second."""
        learner = self.one_shot_learner
        if z is None:
            seed = learner.generator.initial_seed() + int(time.time())
            z = torch.randn(self.num_outs, learner.model_config.latent_dim,
                            generator=torch.Generator().manual_seed(seed % 2**63))
        z = torch.as_tensor(z, dtype=torch.float32, device=learner.device)
        with torch.no_grad():
            self.out_latents = mapping_apply(learner.model, z,
                                             learner.ops).cpu().numpy()
        return self.refresh_grid(
            with_labels=learner.segmentor_params is not None)

    def save(self):
        """The grid's latents as ``snaps/latents_<stamp>.npy``; returns the
        stamp."""
        stamp = time.strftime("%m%d%Y_%H%M%S", time.localtime())
        np.save(os.path.join(self.snap_dir, f"latents_{stamp}.npy"),
                self.out_latents)
        return stamp


class InteractiveLabellerGUI(InteractiveSession, OneShotLabellerGUI):
    """The session in a matplotlib window: the canvas left, the grid right,
    and the session's actions on buttons."""

    def __init__(self, one_shot_learner, cmap="jet", block=None):
        InteractiveSession.__init__(self, one_shot_learner)
        self._open_window(cmap, block)

    # -- layout --------------------------------------------------------

    def _add_buttons(self):
        from matplotlib.gridspec import GridSpec

        # re-lay the figure: input canvas left, output grid right
        self.fig.clf()
        self.fig.set_size_inches(10, 6)
        self.gs = GridSpec(3, 5, figure=self.fig)
        self.ax = self.fig.add_subplot(self.gs[0:2, 0:2])
        self.ax_out = self.fig.add_subplot(self.gs[0:, 2:])
        self.fig.subplots_adjust(left=0.0, bottom=0.0, right=1.0, top=1.0,
                                 wspace=0.01)
        self.ax.axis("off")
        self.ax_out.axis("off")
        self.ax_img = self.ax.imshow(self.images[self.img_idx], cmap=self.cmap)
        self.ax_img_o = self.ax_out.imshow(self.out_grid, cmap=self.cmap)

        self.class_box = self._button(
            [0.00, 0.23, 0.12, 0.04], self.class_labels[self._class],
            color=list(self.colors[self._class]),
            hovercolor=list(self.colors[self._class]))
        self.prev_class_btn = self._button([0.00, 0.18, 0.05, 0.04], "<")
        self.prev_class_btn.on_clicked(self._prev_class)
        self.next_class_btn = self._button([0.07, 0.18, 0.05, 0.04], ">")
        self.next_class_btn.on_clicked(self._next_class)

        self.lasso_btn = self._button([0.00, 0.13, 0.12, 0.04], "Lasso (L)")
        self.lasso_btn.on_clicked(self._lasso)
        self.brush_up_btn = self._button([0.00, 0.08, 0.05, 0.04], "+")
        self.brush_up_btn.on_clicked(lambda e: self.brush_up())
        self.brush_down_btn = self._button([0.07, 0.08, 0.05, 0.04], "-")
        self.brush_down_btn.on_clicked(lambda e: self.brush_down())

        self.poly_btn = self._button([0.14, 0.13, 0.12, 0.04], "Polygon (P)")
        self.poly_btn.on_clicked(self._poly)
        self.undo_btn = self._button([0.14, 0.08, 0.12, 0.04], "Undo (Z)")
        self.undo_btn.on_clicked(self._undo)
        self.overlay_btn = self._button([0.14, 0.18, 0.12, 0.04], "Overlay (O)")
        self.overlay_btn.on_clicked(self._overlay)

        self.prev_img_btn = self._button([0.00, 0.03, 0.05, 0.04], "Prev")
        self.prev_img_btn.on_clicked(self._prev_img)
        self.next_img_btn = self._button([0.07, 0.03, 0.05, 0.04], "Next")
        self.next_img_btn.on_clicked(self._next_img)

        self.reset_btn = self._button(
            [0.14, 0.03, 0.12, 0.04], "Reset",
            color=[1, 0.3, 0.3], hovercolor=[1, 0.5, 0.5])
        self.reset_btn.on_clicked(self._reset_evt)

        self.train_btn = self._button([0.27, 0.13, 0.14, 0.04], "Update/Train")
        self.train_btn.on_clicked(self._update_or_train)
        self.regenerate_btn = self._button([0.27, 0.08, 0.14, 0.04],
                                           "Regenerate")
        self.regenerate_btn.on_clicked(lambda e: self.regenerate())
        self.save_btn = self._button([0.27, 0.03, 0.14, 0.04], "Save")
        self.save_btn.on_clicked(self._save_output)

        self.status = self._button([0.27, 0.18, 0.14, 0.04],
                                   "Status: Labelling")

    # -- actions -------------------------------------------------------

    def refresh_grid(self, with_labels=True):
        super().refresh_grid(with_labels)
        self.ax_img_o.set_data(self.out_grid)
        self.fig.canvas.draw_idle()
        return self.out_grid

    def _update_or_train(self, event):
        self.status.label.set_text("Status: Updating")
        self.update_or_train()
        self.status.label.set_text("Status: Labelling")

    def _save_output(self, event):
        stamp = self.save()
        self.fig.savefig(os.path.join(self.snap_dir, f"snap_{stamp}.png"))
