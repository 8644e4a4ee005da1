// Rectifier with re-quantization (DAIS opcode +/-2): v = +/-a;
// o = v < 0 ? 0 : wrap(v << SHIFT) with SHIFT = f_out - f_in.
module relu #(
    parameter WA = 8,
    parameter SA = 1,
    parameter NEG = 0,
    parameter SHIFT = 0,
    parameter WO = 8
) (
    input  [WA-1:0] a,
    output [WO-1:0] o
);
    localparam SHL = SHIFT > 0 ? SHIFT : 0;
    localparam SHR = SHIFT < 0 ? -SHIFT : 0;
    localparam WI = (WA > WO + SHR ? WA : WO + SHR) + SHL + 2;
    wire signed [WI-1:0] ea = SA ? $signed(a) : $signed({1'b0, a});
    wire signed [WI-1:0] v = NEG ? -ea : ea;
    wire signed [WI-1:0] shifted = (v <<< SHL) >>> SHR;
    assign o = v[WI-1] ? {WO{1'b0}} : shifted[WO-1:0];
endmodule
