"""One-shot labelling GUI: a mask painter over matplotlib widgets (port of
ganecdotes_tpu/gui/labeller.py).

Lasso and polygon tools rasterised by cv2, brush size, a colour per class
(class 0 white in the GUI), undo history, an overlay toggle, previous and
next image, and the keyboard shortcuts c, v, z, left, right, o, up, down.

``MaskPainter`` is the painting state without any window, so it runs
headless; ``OneShotLabellerGUI`` adds the matplotlib event glue. cv2 and
matplotlib are imported inside the methods that use them: this module
imports numpy only. The window blocks in ``plt.show()`` only on an
interactive backend.
"""

import copy

import numpy as np

from ganecdotes_torch.utils.visualization import (  # noqa: F401 (re-export)
    sample_label_colors,
    visualize_label_mask,
)


class MaskPainter:
    """Label-painting state: (num_images, H, W) uint8 labels, painted by
    cv2 from polygons and lasso strokes, with an undo history."""

    def __init__(self, images, class_labels):
        self.images = np.asarray(images)
        self.num_images = len(self.images)
        self.img_idx = 0
        self.class_labels = class_labels or ["target", "background"]
        self.num_classes = len(self.class_labels)
        self.colors = sample_label_colors(self.num_classes)
        self.colors[0] = np.array([1.0, 1.0, 1.0])
        self._class = 1
        self.brush_size = 1
        self.history = []
        self.show_overlay = True
        self._reset_label()

    # -- state ---------------------------------------------------------

    def _reset_label(self, only_current_img=False):
        h, w = self.images.shape[1], self.images.shape[2]
        if only_current_img:
            self.labels[self.img_idx] = np.zeros((h, w), np.uint8)
        else:
            self.labels = np.zeros((self.num_images, h, w), np.uint8)

    def next_class(self):
        self._class = (self._class + 1) % self.num_classes

    def prev_class(self):
        self._class = (self._class - 1) % self.num_classes

    def brush_up(self):
        self.brush_size += 1

    def brush_down(self):
        self.brush_size = max(self.brush_size - 1, 1)

    # -- painting ------------------------------------------------------

    def add_polygon(self, vertices):
        """Fill a polygon with the current class."""
        poly = np.array(vertices, np.int32).reshape((-1, 1, 2))
        inputs = ("poly", poly, self._class)
        self.history.append(inputs)
        self._update_label(inputs)

    def add_lasso(self, vertices):
        """Stroke a path with the current class at the brush size."""
        path = np.array(vertices, np.int32).reshape((-1, 1, 2))
        path = np.unique(path, axis=1)
        inputs = ("lasso", path, self._class, self.brush_size)
        self.history.append(inputs)
        self._update_label(inputs)

    def _update_label(self, inputs):
        import cv2

        if inputs[0] == "poly":
            self.labels[self.img_idx] = cv2.fillPoly(
                self.labels[self.img_idx], [inputs[1]], inputs[2], 0)
        elif inputs[0] == "lasso":
            self.labels[self.img_idx] = cv2.polylines(
                self.labels[self.img_idx], [inputs[1]], isClosed=False,
                color=inputs[2], thickness=inputs[3])

    def undo(self):
        if self.history:
            self.history.pop(-1)
            self._reset_label(only_current_img=True)
            for inputs in self.history:
                self._update_label(inputs)

    def reset(self):
        self.history = []
        self._reset_label(only_current_img=True)

    # -- rendering -----------------------------------------------------

    def get_visualized_label(self, label=None):
        if label is None:
            label = self.labels[self.img_idx]
        label_image = np.zeros_like(self.images[self.img_idx])
        for c in range(1, self.num_classes):
            label_image[label == c] = self.colors[c]
        return label_image

    def get_image_label_overlay(self):
        overlay = self.images[self.img_idx].copy()
        label_image = self.get_visualized_label()
        non_zeros = label_image > 0
        overlay[non_zeros] = label_image[non_zeros]
        return overlay

    def get_labels(self):
        return self.labels


class OneShotLabellerGUI(MaskPainter):
    """The matplotlib front end: the painter's canvas, its buttons and
    keyboard shortcuts."""

    def __init__(self, images, class_labels, cmap="jet", block=None):
        super().__init__(images, class_labels)
        self._open_window(cmap, block)

    def _open_window(self, cmap, block):
        """The figure, its widgets (``_add_buttons``) and key bindings;
        ``plt.show()`` when ``block`` (by default: on an interactive
        backend)."""
        import matplotlib
        import matplotlib.pyplot as plt
        from matplotlib import widgets

        self._plt = plt
        self._widgets = widgets
        self.cmap = cmap

        self.fig = plt.figure("One Shot Labelling GUI")
        self.ax = self.fig.add_subplot()
        self.fig.subplots_adjust(left=0.0, bottom=0.0, right=0.80, top=1.0)
        self.ax.axis("off")
        self.ax_img = self.ax.imshow(self.images[self.img_idx], cmap=cmap)

        self._add_buttons()
        self.fig.canvas.mpl_connect("key_press_event", self._key_maps)

        if block is None:
            block = matplotlib.get_backend().lower() not in ("agg", "pdf", "svg")
        if block:
            plt.show()

    # -- widgets -------------------------------------------------------

    def _button(self, coords, label, **kw):
        return self._widgets.Button(self._plt.axes(coords), label, **kw)

    def _add_buttons(self):
        interval = 0.08
        coords = [0.84, 0.94, 0.15, 0.05]
        self.class_box = self._button(
            coords, self.class_labels[self._class],
            color=list(self.colors[self._class]),
            hovercolor=list(self.colors[self._class]))

        coords[1] -= interval
        split = copy.deepcopy(coords)
        split[2] = 0.06
        self.prev_class_btn = self._button(split, "<")
        self.prev_class_btn.on_clicked(self._prev_class)
        split[0] = 0.84 + 0.15 - 0.06
        self.next_class_btn = self._button(split, ">")
        self.next_class_btn.on_clicked(self._next_class)

        coords[1] -= interval
        self.lasso_btn = self._button(coords, "Brush (C)")
        self.lasso_btn.on_clicked(self._lasso)

        coords[1] -= interval
        split = copy.deepcopy(coords)
        split[2] = 0.06
        self.brush_up_btn = self._button(split, "+")
        self.brush_up_btn.on_clicked(lambda e: self.brush_up())
        split[0] = 0.84 + 0.15 - 0.06
        self.brush_down_btn = self._button(split, "-")
        self.brush_down_btn.on_clicked(lambda e: self.brush_down())

        coords[1] -= interval
        self.poly_btn = self._button(coords, "Polygon (V)")
        self.poly_btn.on_clicked(self._poly)

        coords[1] -= interval
        self.undo_btn = self._button(coords, "Undo (Z)")
        self.undo_btn.on_clicked(self._undo)

        coords[1] -= interval
        self.overlay_btn = self._button(coords, "Overlay (O)")
        self.overlay_btn.on_clicked(self._overlay)

        coords[1] -= interval
        self.reset_btn = self._button(
            coords, "Reset", color=[1, 0.3, 0.3], hovercolor=[1, 0.5, 0.5])
        self.reset_btn.on_clicked(self._reset_evt)

        coords[1] -= interval
        split = copy.deepcopy(coords)
        split[2] = 0.06
        self.prev_img_btn = self._button(split, "Prev")
        self.prev_img_btn.on_clicked(self._prev_img)
        split[0] = 0.84 + 0.15 - 0.06
        self.next_img_btn = self._button(split, "Next")
        self.next_img_btn.on_clicked(self._next_img)

    def _key_maps(self, event):
        key_maps = {
            "c": self._lasso, "v": self._poly, "z": self._undo,
            "right": self._next_class, "left": self._prev_class,
            "o": self._overlay, "up": lambda e: self.brush_up(),
            "down": lambda e: self.brush_down(),
        }
        key = (event.key or "").lower()
        if key in key_maps:
            key_maps[key](None)

    # -- event handlers ------------------------------------------------

    def _draw(self, image):
        self.ax_img.set_data(image)
        self.fig.canvas.draw_idle()

    def _next_class(self, event):
        self.next_class()
        self._update_class_box()

    def _prev_class(self, event):
        self.prev_class()
        self._update_class_box()

    def _update_class_box(self):
        self.class_box.label.set_text(self.class_labels[self._class])
        self.class_box.color = list(self.colors[self._class])
        self.class_box.hovercolor = self.class_box.color
        self.fig.canvas.draw_idle()

    def _lasso(self, event):
        self._reset_selectors()
        self.lasso_selector = self._widgets.LassoSelector(
            self.ax, self._process_lasso)

    def _process_lasso(self, vert):
        self.add_lasso(vert)
        self._after_new_label()
        self._reset_selectors()

    def _poly(self, event):
        self._reset_selectors()
        self.poly_selector = self._widgets.PolygonSelector(
            self.ax, self._process_polygon)

    def _process_polygon(self, vert):
        self.add_polygon(vert)
        self._after_new_label()
        self._reset_selectors()

    def _reset_selectors(self):
        for name in ("lasso_selector", "poly_selector"):
            if hasattr(self, name):
                getattr(self, name).set_visible(False)
                delattr(self, name)

    def _undo(self, event):
        self.undo()
        self._draw(self.get_image_label_overlay())

    def _overlay(self, event):
        self.show_overlay = not self.show_overlay
        self._draw(self.get_image_label_overlay() if self.show_overlay
                   else self.images[self.img_idx])

    def _reset_evt(self, event):
        self.reset()
        self._draw(self.images[self.img_idx])

    def _next_img(self, event):
        self.img_idx = (self.img_idx + 1) % self.num_images
        self._on_img_change()

    def _prev_img(self, event):
        self.img_idx = (self.img_idx - 1) % self.num_images
        self._on_img_change()

    def _on_img_change(self):
        self.history = []
        self.show_overlay = True
        self._draw(self.get_image_label_overlay())

    def _after_new_label(self):
        self.show_overlay = True
        self._draw(self.get_image_label_overlay())
