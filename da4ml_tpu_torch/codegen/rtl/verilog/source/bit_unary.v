// Bitwise unary op (DAIS opcode +/-9) on v = +/-a (wrapped to W0 bits):
// OP=0 NOT (over WO bits), OP=1 OR-reduce (v != 0), OP=2 AND-reduce (&v[W0]).
module bit_unary #(
    parameter WA = 8,
    parameter SA = 1,
    parameter W0 = 8,
    parameter NEG = 0,
    parameter OP = 0,
    parameter WO = 8
) (
    input  [WA-1:0] a,
    output [WO-1:0] o
);
    localparam WI = (WA > WO ? WA : WO) + 2;
    wire signed [WI-1:0] ea = SA ? $signed(a) : $signed({1'b0, a});
    wire signed [WI-1:0] v = NEG ? -ea : ea;
    wire [W0-1:0] vw = v[W0-1:0];
    generate
        if (OP == 0) begin : g_not
            wire signed [WI-1:0] r = ~v;
            assign o = r[WO-1:0];
        end else if (OP == 1) begin : g_any
            assign o = |vw;  // implicit zero-extension to WO bits
        end else begin : g_all
            assign o = &vw;
        end
    endgenerate
endmodule
